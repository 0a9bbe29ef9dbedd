"""Sphere-bounded SDF march for occlusion probability (no gradient).

Counterpart of nero_tpu/fields/intersection.py: a 2-pass importance march
along reflection rays, fixed-shape and masked (rows whose origin is outside
the 0.999-sphere give zero weights and sdf -1).
"""
from __future__ import annotations

import torch

from nero_tpu_torch.ops.sample_pdf import sample_pdf
from nero_tpu_torch.utils.sphere import get_sphere_intersection


def get_weights(sdf_fun, inv_s, z_vals, origins, dirs):
    """NeuS weights [P, S-1] and section sdf [P, S-1] (-1 off-surface)."""
    points = origins[:, None, :] + dirs[:, None, :] * z_vals[..., None]
    sdf = sdf_fun(points)[..., 0]
    prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
    prev_z, next_z = z_vals[:, :-1], z_vals[:, 1:]
    mid_sdf = (prev_sdf + next_sdf) * 0.5
    cos_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)
    surface_mask = cos_val < 0
    cos_val = torch.clamp(cos_val, max=0.0)
    dist = next_z - prev_z
    prev_cdf = torch.sigmoid((mid_sdf - cos_val * dist * 0.5) * inv_s)
    next_cdf = torch.sigmoid((mid_sdf + cos_val * dist * 0.5) * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5) * surface_mask.to(sdf.dtype)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-7],
                                    dim=-1), dim=-1)[:, :-1]
    return alpha * trans, torch.where(surface_mask, mid_sdf, torch.full_like(mid_sdf, -1.0))


@torch.no_grad()
def get_intersection(sdf_fun, inv_s, pts, dirs, sn0: int = 128, sn1: int = 9):
    """pts, dirs [P, 3] -> (hit_z, hit_weights, hit_sdf), each [P, sn1-1]."""
    inside = torch.linalg.norm(pts, dim=-1) < 0.999
    safe_pts = torch.where(inside[:, None], pts, torch.zeros_like(pts))
    max_dist = get_sphere_intersection(safe_pts, dirs)
    z0 = torch.linspace(0.0, 1.0, sn0, dtype=pts.dtype, device=pts.device)
    z_vals = max_dist * z0[None, :]
    weights, _ = get_weights(sdf_fun, inv_s, z_vals, safe_pts, dirs)
    z_new = sample_pdf(z_vals, weights, sn1)
    weights, mid_sdf = get_weights(sdf_fun, inv_s, z_new, safe_pts, dirs)
    z_mid = (z_new[:, 1:] + z_new[:, :-1]) * 0.5
    insf = inside[:, None]
    return (torch.where(insf, z_mid, torch.zeros_like(z_mid)),
            torch.where(insf, weights, torch.zeros_like(weights)),
            torch.where(insf, mid_sdf, torch.full_like(mid_sdf, -1.0)))
