"""Exact mesh ray tracer on the host: C++ BVH build and OpenMP traversal.

Counterpart of the host half of nero_tpu/geometry/bvh_jax.py (`RayTracer`'s
constructor, `trace_cpu`, `_bvh_np`). Stage II uses it for the one-time
precompute passes (first hit of every training pixel, hemisphere hit rates,
validation views) and to verify the neural tracer. The device wavefront
traversal (`bvh_trace`, bvh_jax.py:46) is not ported yet, so this tracer has
no `trace_fn` and the material model refuses `tracer: bvh`.
"""
from __future__ import annotations

import numpy as np

from nero_tpu_torch.geometry.native import bvh_build, bvh_trace_cpu

LEAF_SIZE = 4


class RayTracer:
    """trace_cpu(rays_o, rays_d) -> (inters [n,3], normals [n,3] geometric,
    depth [n], hit [n] bool); a miss has depth == far and a zero normal. The
    caller applies the NeuS flip to the normals."""

    def __init__(self, vertices: np.ndarray, triangles: np.ndarray, far: float = 10.0,
                 leaf_size: int = LEAF_SIZE):
        assert len(triangles) >= 1, "RayTracer needs at least 1 triangle"
        self.far = far
        self.leaf_size = leaf_size
        self._bvh_np = bvh_build(np.asarray(vertices, np.float32),
                                 np.asarray(triangles, np.int32), leaf_size)

    def trace_cpu(self, rays_o: np.ndarray, rays_d: np.ndarray):
        return bvh_trace_cpu(self._bvh_np, rays_o, rays_d, self.far)
