"""Device resolution for the port's entry points.

Entry points default to CUDA. A caller that wants the CPU says so with
`device="cpu"`; asking for CUDA on a machine without it raises instead of
silently running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> cuda; raises if CUDA is requested but unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev

