"""Sphere-traced visibility on a signed-distance grid.

Counterpart of nero_tpu/geometry/grid_tracer.py. The grid is baked once from
the Stage-I mesh by the host library (`geometry/native.py::mesh_sdf_grid`:
BVH closest-triangle distance + crossing-parity sign). A trace is a fixed
number of iterations, each a trilinear gather and elementwise arithmetic,
identical for every ray: plain tensor ops on the device, no kernel of its
own (the JAX package has none for it either). Normals are the grid's
gradient. It is the exact-geometry backend of Stage II: `tracer: grid`, and
the fallback where a mesh is too hard for the distilled field
(`tracer_rms_fallback`).
"""
from __future__ import annotations

import numpy as np
import torch

from nero_tpu_torch.geometry.bvh import RayTracer
from nero_tpu_torch.geometry.native import mesh_sdf_grid


def _trilerp(grid_flat: torch.Tensor, res: int, pts01: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of an x-major [res^3] grid at normalised coords [R,3]."""
    g = pts01 * (res - 1)
    g0 = torch.clamp(torch.floor(g), 0, res - 2)
    f = g - g0
    xi, yi, zi = (g0[:, k].long() for k in range(3))
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]

    def at(dx, dy, dz):
        return grid_flat[((xi + dx) * res + (yi + dy)) * res + (zi + dz)]

    c00 = at(0, 0, 0) * (1 - fz) + at(0, 0, 1) * fz
    c01 = at(0, 1, 0) * (1 - fz) + at(0, 1, 1) * fz
    c10 = at(1, 0, 0) * (1 - fz) + at(1, 0, 1) * fz
    c11 = at(1, 1, 0) * (1 - fz) + at(1, 1, 1) * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


@torch.no_grad()
def grid_sphere_trace(grid_flat, bmin, inv_extent, res: int, rays_o, rays_d, far=10.0,
                      n_steps: int = 64, t0: float = 0.015, hit_thresh: float = 2e-3):
    """Sphere trace rays against the SDF grid. Returns (t [R], normal [R,3]
    inward (-grad, the BVH tracer's winding convention, so that the caller's
    NeuS flip yields outward), hit [R])."""
    bmax = bmin + 1.0 / inv_extent
    voxel = 1.0 / (res * inv_extent.max())   # a 0-d tensor: no host read in the trace

    def sample(pts):
        d = _trilerp(grid_flat, res, torch.clamp((pts - bmin) * inv_extent, 0.0, 1.0))
        # outside the grid box: the distance to the box keeps the march moving
        out_d = torch.maximum((bmin - pts).max(dim=-1).values, (pts - bmax).max(dim=-1).values)
        return torch.where(out_d > 0, torch.maximum(d, out_d), d)

    min_step = 0.5 * voxel  # half-voxel floor
    t = torch.full((rays_o.shape[0],), t0, dtype=rays_o.dtype, device=rays_o.device)
    done_t = torch.full_like(t, -1.0)
    for _ in range(n_steps):
        d = sample(rays_o + rays_d * t[:, None])
        done_t = torch.where((done_t < 0) & (d < hit_thresh), t, done_t)
        step = torch.clamp(d, min=min_step)
        t = torch.where(done_t < 0, torch.clamp(t + step, max=far), t)
    hit = done_t >= 0
    far_t = torch.full_like(t, far)
    t_hit = torch.where(hit, done_t, far_t)

    # one Newton refinement (|grad sdf| ~ 1) + gradient normal at the hit
    d = sample(rays_o + rays_d * t_hit[:, None])
    t_hit = torch.where(hit, torch.clamp(t_hit + d, min=0.0), far_t)
    pts = rays_o + rays_d * t_hit[:, None]
    offs = torch.eye(3, dtype=pts.dtype, device=pts.device) * voxel
    grad = torch.stack([sample(pts + offs[k]) - sample(pts - offs[k]) for k in range(3)], dim=-1)
    gn = torch.linalg.norm(grad, dim=-1, keepdim=True)
    normal = torch.where(hit[:, None], -grad / torch.clamp(gn, min=1e-9),
                         torch.zeros_like(grad))
    return t_hit, normal, hit


class GridTracer:
    """Tracer of a fixed mesh backed by a baked SDF grid.

    trace(rays_o, rays_d) -> (inters, normals (inward), depth [R,1], hit); a
    miss has depth == far. Also owns the exact BVH (`trace_cpu`, the host
    trace of the one-time precompute passes)."""

    def __init__(self, vertices: np.ndarray, triangles: np.ndarray, res: int = 256,
                 far: float = 10.0, margin: float = 0.03, n_steps: int = 64, device="cpu"):
        self.far = far
        self.res = res
        self.n_steps = n_steps
        self.device = torch.device(device)
        self._bvh_tracer = RayTracer(vertices, triangles, far=far)
        bmin = (vertices.min(0) - margin).astype(np.float32)
        bmax = (vertices.max(0) + margin).astype(np.float32)
        grid = mesh_sdf_grid(self._bvh_tracer._bvh_np, bmin, bmax, res)
        self.grid_flat = torch.as_tensor(grid.reshape(-1), device=self.device)
        self.bmin = torch.as_tensor(bmin, device=self.device)
        self.inv_extent = torch.as_tensor(1.0 / (bmax - bmin), device=self.device)

    def trace_fn(self):
        def fn(rays_o, rays_d):
            t, normal, hit = grid_sphere_trace(self.grid_flat, self.bmin, self.inv_extent,
                                               self.res, rays_o.detach(), rays_d.detach(),
                                               self.far, self.n_steps)
            inters = rays_o.detach() + rays_d.detach() * t[:, None]
            return inters, normal, t[:, None], hit
        return fn

    def trace(self, rays_o, rays_d):
        return self.trace_fn()(rays_o, rays_d)

    def trace_cpu(self, rays_o, rays_d):
        return self._bvh_tracer.trace_cpu(rays_o, rays_d)
