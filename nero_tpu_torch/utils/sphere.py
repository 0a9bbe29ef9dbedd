"""Sphere sampling and ray / unit-sphere geometry (counterpart of
nero_tpu/utils/sphere.py). The Fibonacci lattice is a float64 numpy constant,
bit-identical in both packages."""
from __future__ import annotations

import numpy as np
import torch


def sample_sphere(num_samples: int, begin_elevation: float = 0.0):
    """Fibonacci-spiral sphere sampling; returns (azimuths, elevations) np arrays."""
    ratio = (begin_elevation + 90.0) / 180.0
    num_points = int(num_samples // (1 - ratio))
    phi = (np.sqrt(5.0) - 1.0) / 2.0
    n = np.arange(num_points - num_samples, num_points, dtype=np.float64)
    z = 2.0 * n / num_points - 1.0
    azimuths = (2.0 * np.pi * n * phi) % (2.0 * np.pi)
    elevations = np.arcsin(z)
    return azimuths, elevations


def az_el_to_points(azimuths, elevations):
    """Azimuth/elevation -> unit xyz (z = up)."""
    z = np.sin(elevations)
    x = np.cos(azimuths) * np.cos(elevations)
    y = np.sin(azimuths) * np.cos(elevations)
    return np.stack([x, y, z], -1)


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
