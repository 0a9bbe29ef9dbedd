"""Repo-root anchoring for on-disk artefacts that the repository owns
(bundled configs such as `configs/synthetic_split_128.pkl`, derived
caches), so that entry points run from any working directory find them.
What the user owns (data/model, data/meshes, ...) stays relative to the
working directory."""
from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def repo_path(*parts: str) -> str:
    return os.path.join(REPO_ROOT, *parts)
