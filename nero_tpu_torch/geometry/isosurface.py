"""SDF grid evaluation on the device in chunks, then the iso-surface on the host.

Counterpart of nero_tpu/geometry/isosurface.py: evaluate the SDF over a dense
grid (points on or outside the unit sphere take `outside_val`), extract the
0-level set with the host library (surface nets, or marching tetrahedra),
rescale the vertices to the bounding box. The grid's axes are the same
float32 `np.linspace` values; they move to the device once and every chunk's
points are built there from the flat index. The whole grid stays on the
device and comes to the host in one copy.

The sign of each grid value decides the mesh, so the query runs in float32
(TF32 stays as the caller set it; PyTorch's default is off): a value moved by
1e-6 near zero adds or drops a triangle.
"""
from __future__ import annotations

import numpy as np
import torch

from nero_tpu_torch.core.device import resolve_device
from nero_tpu_torch.geometry import native


@torch.no_grad()
def extract_fields(bound_min, bound_max, resolution: int, query_fn,
                   outside_val: float = 1.0, chunk: int = 262144, device=None) -> np.ndarray:
    """query_fn(points [n,3] on `device`) -> [n] or [n,1], over a
    resolution^3 grid (x slowest, z fastest); returns the grid as numpy."""
    dev = resolve_device(device)
    lo = np.asarray(bound_min, np.float32)
    hi = np.asarray(bound_max, np.float32)
    xs, ys, zs = (torch.as_tensor(np.linspace(lo[i], hi[i], resolution, dtype=np.float32),
                                  device=dev) for i in range(3))
    total = resolution ** 3
    yz = resolution * resolution
    u = torch.empty(total, dtype=torch.float32, device=dev)
    for start in range(0, total, chunk):
        idx = torch.arange(start, min(start + chunk, total), device=dev)
        pts = torch.stack([xs[idx // yz], ys[(idx % yz) // resolution], zs[idx % resolution]], -1)
        val = query_fn(pts)
        if val.ndim > 1:
            val = val[..., 0]
        outside = torch.linalg.norm(pts, dim=-1) >= 1.0
        u[start:start + len(idx)] = torch.where(outside, outside_val, val)
    return u.reshape(resolution, resolution, resolution).cpu().numpy()


def surface_from_grid(u: np.ndarray, bound_min, bound_max, threshold: float,
                      method: str = "surface_nets"):
    """The `threshold` level set of grid `u` over the box, on the host:
    'surface_nets' (cell-centred vertices, smoother) or 'marching_tets'
    (edge-interpolated vertices, of the marching-cubes family). Returns
    (vertices [V,3] f32 world coordinates, triangles [T,3] i32)."""
    if method == "marching_tets":
        vertices, triangles = native.isosurface_mt(u, threshold)
    elif method == "surface_nets":
        vertices, triangles = native.isosurface(u, threshold)
    else:
        raise ValueError(f"unknown iso-surface method {method!r}")
    lo = np.asarray(bound_min, np.float32)
    hi = np.asarray(bound_max, np.float32)
    vertices = vertices / (u.shape[0] - 1.0) * (hi - lo)[None, :] + lo[None, :]
    return vertices.astype(np.float32), triangles


def extract_geometry(bound_min, bound_max, resolution: int, threshold: float, query_fn,
                     outside_val: float = 1.0, method: str = "surface_nets", device=None):
    """Grid evaluation on the device, then `surface_from_grid`."""
    u = extract_fields(bound_min, bound_max, resolution, query_fn, outside_val, device=device)
    return surface_from_grid(u, bound_min, bound_max, threshold, method)
