"""Exact mesh ray tracer: C++ BVH build on the host, traversal on the host
(OpenMP) or on the device (a stackless wavefront in plain tensor ops).

Counterpart of nero_tpu/geometry/bvh_jax.py. Stage II uses the host trace for
the one-time precompute passes (first hit of every training pixel, hemisphere
hit rates, validation views) and to verify the other tracers. The device
trace (`bvh_trace`, `RayTracer.trace` / `trace_fn`, the `tracer: bvh`
backend) is exact too but slow: every ray carries a current-node pointer into
the DFS-flattened BVH with hit / miss links, and one loop iteration advances
all rays one node (slab test, then follow a link; leaves intersect up to
`leaf_size` triangles with Moller-Trumbore) until no ray is live. It is no
kernel in the JAX package either; it serves small meshes and debugging.
"""
from __future__ import annotations

import numpy as np
import torch

from nero_tpu_torch.geometry.native import bvh_build, bvh_trace_cpu

LEAF_SIZE = 4


def _moller_trumbore(o, d, v0, e1, e2):
    """Ray / triangle intersection, all [R,3]. Returns (t, hit)."""
    p = torch.linalg.cross(d, e2)
    det = torch.sum(e1 * p, dim=-1)
    small = det.abs() < 1e-12
    inv_det = 1.0 / torch.where(small, torch.full_like(det, 1e-12), det)
    tv = o - v0
    u = torch.sum(tv * p, dim=-1) * inv_det
    q = torch.linalg.cross(tv, e1)
    v = torch.sum(d * q, dim=-1) * inv_det
    t = torch.sum(e2 * q, dim=-1) * inv_det
    hit = ~small & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-4)
    return t, hit


@torch.no_grad()
def bvh_trace(nodes_f, nodes_i, tri_data, rays_o, rays_d, far=10.0,
              leaf_size: int = LEAF_SIZE):
    """Trace rays against a flattened BVH.

    nodes_f [N,8] (bmin, bmax, pad 2); nodes_i [N,4] (tri_start | -1, count,
    miss link, pad); tri_data [T,9] (v0, e1, e2); rays_o / rays_d [R,3].
    Returns (t [R], normal [R,3] geometric, normalised, hit [R])."""
    r = rays_o.shape[0]
    tiny = torch.where(rays_d >= 0, torch.full_like(rays_d, 1e-12),
                       torch.full_like(rays_d, -1e-12))
    inv_d = 1.0 / torch.where(rays_d.abs() > 1e-12, rays_d, tiny)
    node = torch.zeros(r, dtype=torch.long, device=rays_o.device)
    best_t = torch.full((r,), far, dtype=rays_o.dtype, device=rays_o.device)
    best_n = torch.zeros(r, 3, dtype=rays_o.dtype, device=rays_o.device)
    last_tri = tri_data.shape[0] - 1
    # the loop's condition reads the device once per wavefront step
    while bool((node >= 0).any()):
        live = node >= 0
        idx = torch.clamp(node, min=0)
        f = nodes_f[idx]
        m = nodes_i[idx].long()
        ta = (f[:, 0:3] - rays_o) * inv_d
        tb = (f[:, 3:6] - rays_o) * inv_d
        t0 = torch.minimum(ta, tb).max(dim=-1).values
        t1 = torch.maximum(ta, tb).min(dim=-1).values
        box_hit = (torch.clamp(t0, min=1e-4) <= torch.minimum(t1, best_t)) & live

        is_leaf = m[:, 0] >= 0
        process = box_hit & is_leaf
        tri_start = torch.clamp(m[:, 0], min=0)
        for s in range(leaf_size):
            td = tri_data[torch.clamp(tri_start + s, max=last_tri)]
            e1, e2 = td[:, 3:6], td[:, 6:9]
            t, tri_hit = _moller_trumbore(rays_o, rays_d, td[:, 0:3], e1, e2)
            valid = process & (s < m[:, 1]) & tri_hit & (t < best_t)
            best_n = torch.where(valid[:, None], torch.linalg.cross(e1, e2), best_n)
            best_t = torch.where(valid, t, best_t)

        # next pointer: internal and hit -> first child (node + 1); else the miss link
        nxt = torch.where(box_hit & ~is_leaf, node + 1, m[:, 2])
        node = torch.where(live, nxt, node)

    hit = best_t < far
    nl = torch.linalg.norm(best_n, dim=-1, keepdim=True)
    normal = torch.where(hit[:, None] & (nl > 0), best_n / torch.clamp(nl, min=1e-12),
                         torch.zeros_like(best_n))
    return best_t, normal, hit


class RayTracer:
    """trace(rays_o, rays_d) on the device and trace_cpu on the host, both ->
    (inters [n,3], normals [n,3] geometric, depth, hit [n] bool); a miss has
    depth == far and a zero normal; depth is [n,1] from the device trace and
    [n] from the host trace, as in the JAX package. The caller applies the
    NeuS flip to the normals. The BVH is copied to `device` on first use of
    the device trace."""

    def __init__(self, vertices: np.ndarray, triangles: np.ndarray, far: float = 10.0,
                 leaf_size: int = LEAF_SIZE, device="cpu"):
        assert len(triangles) >= 1, "RayTracer needs at least 1 triangle"
        self.far = far
        self.leaf_size = leaf_size
        self.device = torch.device(device)
        self._bvh_np = bvh_build(np.asarray(vertices, np.float32),
                                 np.asarray(triangles, np.int32), leaf_size)
        self._bvh_dev = None

    def trace_fn(self):
        if self._bvh_dev is None:
            self._bvh_dev = tuple(torch.as_tensor(self._bvh_np[k], device=self.device)
                                  for k in ("nodes_f", "nodes_i", "tri_data"))
        nodes_f, nodes_i, tri_data = self._bvh_dev

        def fn(rays_o, rays_d):
            rays_o, rays_d = rays_o.detach(), rays_d.detach()
            t, normal, hit = bvh_trace(nodes_f, nodes_i, tri_data, rays_o, rays_d, self.far,
                                       self.leaf_size)
            return rays_o + rays_d * t[:, None], normal, t[:, None], hit
        return fn

    def trace(self, rays_o, rays_d):
        return self.trace_fn()(rays_o, rays_d)

    def trace_cpu(self, rays_o: np.ndarray, rays_d: np.ndarray):
        return bvh_trace_cpu(self._bvh_np, rays_o, rays_d, self.far)
