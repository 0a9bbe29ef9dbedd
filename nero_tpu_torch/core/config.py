"""YAML config loading (flat YAML over a default dict, as nero_tpu does)."""
from __future__ import annotations

import yaml


def load_cfg(path: str) -> dict:
    with open(path, "r") as f:
        return yaml.safe_load(f)


def merge_cfg(default_cfg: dict, cfg: dict) -> dict:
    return {**default_cfg, **cfg}
