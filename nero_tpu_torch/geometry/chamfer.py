"""Symmetric Chamfer distance between point clouds: brute-force nearest
neighbours on the device, in chunks.

Counterpart of nero_tpu/geometry/chamfer.py: |q - r|^2 = |q|^2 - 2 q.r + |r|^2
in float32, the q.r term one matrix product per [chunk, N] block, the
reference cloud moved to the device once. The form cancels for nearly equal
points, so the minimum is clamped at 0 before the square root.
"""
from __future__ import annotations

import numpy as np
import torch

from nero_tpu_torch.core.device import resolve_device


def _nn_dist_chunk(query: torch.Tensor, ref: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """min_j |q_i - r_j| for a [C,3] query chunk against [N,3] refs (r2 = |r|^2)."""
    q2 = torch.sum(query ** 2, dim=-1, keepdim=True)
    # q2 - 2 q.r + r2, rounded in that order, in one [C, N] buffer
    d2 = (query @ ref.T).mul_(-2.0).add_(q2).add_(r2[None, :])
    return torch.sqrt(torch.clamp(torch.amin(d2, dim=-1), min=0.0))


@torch.no_grad()
def nearest_dist(query: np.ndarray, ref: np.ndarray, chunk: int = 8192,
                 device=None) -> np.ndarray:
    """Distance from each query point to its nearest reference point."""
    dev = resolve_device(device)
    q = torch.as_tensor(np.asarray(query, np.float32), device=dev)
    r = torch.as_tensor(np.asarray(ref, np.float32), device=dev)
    if len(q) == 0:
        return np.empty((0,), np.float32)
    r2 = torch.sum(r ** 2, dim=-1)
    out = torch.cat([_nn_dist_chunk(q[i:i + chunk], r, r2) for i in range(0, len(q), chunk)])
    return out.cpu().numpy()


def chamfer_distance(pts0: np.ndarray, pts1: np.ndarray, chunk: int = 8192, device=None):
    """Returns (mean symmetric chamfer, d0->1 mean, d1->0 mean)."""
    d01 = nearest_dist(pts0, pts1, chunk, device).mean()
    d10 = nearest_dist(pts1, pts0, chunk, device).mean()
    return (d01 + d10) / 2.0, d01, d10
