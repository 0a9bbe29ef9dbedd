"""Mesh of a procedural scene, made on the host from its analytic SDF: the
exact surface that Stage II's cells and the tracer checks run on (a mesh
that Stage I made comes from `python -m nero_tpu_torch.extract_mesh`).

    python -m nero_tpu_torch.geometry.proc_mesh bowl data/meshes/proc_bowl.ply

samples the scene's SDF on a 128^3 grid over [-1.01, 1.01]^3, extracts the
iso-surface with the host library and writes a PLY (what nero_tpu's bench
does for its Stage-II cells).
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from nero_tpu_torch.dataset.synthetic import scene_sdf
from nero_tpu_torch.geometry.isosurface import surface_from_grid
from nero_tpu_torch.geometry.mesh_io import write_ply


def proc_mesh(scene: str, grid: int = 128, lo: float = -1.01, hi: float = 1.01) -> dict:
    """{'vertices' [V,3] f32, 'triangles' [T,3] i32} of scene 'sphere' | 'bowl' | ..."""
    xs = np.linspace(lo, hi, grid).astype(np.float32)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    vals = np.asarray(scene_sdf(scene)(np.stack([X, Y, Z], -1).reshape(-1, 3)),
                      np.float32).reshape(grid, grid, grid)
    verts, tris = surface_from_grid(vals, [lo] * 3, [hi] * 3, 0.0)
    return {"vertices": verts, "triangles": tris}


def surface_rays(mesh: dict, n: int, seed: int = 0):
    """Area-weighted surface points with random directions, o = p + 1e-3 d:
    the visibility rays of Stage II."""
    rng = np.random.RandomState(seed)
    verts, tris = mesh["vertices"], mesh["triangles"]
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    areas = np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    ti = rng.choice(len(tris), n, p=areas / areas.sum())
    u, v = rng.rand(n, 1), rng.rand(n, 1)
    flip = (u + v) > 1
    u, v = np.where(flip, 1 - u, u), np.where(flip, 1 - v, v)
    p = v0[ti] + u * (v1[ti] - v0[ti]) + v * (v2[ti] - v0[ti])
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (p + d * 1e-3).astype(np.float32), d.astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scene")
    ap.add_argument("out")
    args = ap.parse_args(argv)
    mesh = proc_mesh(args.scene)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    write_ply(args.out, mesh["vertices"], mesh["triangles"])
    print(f"{args.out}: {len(mesh['vertices'])} vertices, {len(mesh['triangles'])} triangles")


if __name__ == "__main__":
    main()
