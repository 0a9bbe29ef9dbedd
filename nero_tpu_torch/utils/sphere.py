"""Ray / unit-sphere geometry (counterpart of nero_tpu/utils/sphere.py:34-56)."""
from __future__ import annotations

import torch


def offset_points_to_sphere(points: torch.Tensor, radius: float = 0.999) -> torch.Tensor:
    norm = torch.linalg.norm(points, dim=-1, keepdim=True)
    scaled = points / torch.clamp(norm, min=1e-12) * radius
    return torch.where(norm > radius, scaled, points)


def get_sphere_intersection(pts: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Distance along `dirs` from inside point `pts` to the unit sphere [..., 1]."""
    dtx = torch.sum(pts * dirs, dim=-1, keepdim=True)
    xtx = torch.sum(pts ** 2, dim=-1, keepdim=True)
    dist = dtx ** 2 - xtx + 1.0
    return -dtx + torch.sqrt(torch.clamp(dist, min=0.0) + 1e-6)


def near_far_from_sphere(rays_o: torch.Tensor, rays_d: torch.Tensor):
    a = torch.sum(rays_d ** 2, dim=-1, keepdim=True)
    b = 2.0 * torch.sum(rays_o * rays_d, dim=-1, keepdim=True)
    mid = 0.5 * (-b) / a
    near = torch.clamp(mid - 1.0, min=1e-3)
    far = mid + 1.0
    return near, far
