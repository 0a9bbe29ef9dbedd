"""Chamfer evaluation of an extracted mesh against a scene's depth cloud:

    python -m nero_tpu_torch.eval_synthetic_shape --mesh data/meshes/bell-300000.ply \
        --object syn/bell

Ground-truth points are fused from the scene's depth maps
(`dataset/database.py::get_database_eval_points`); predicted points from the
mesh's depth, rasterised on the host at the held-out views; both are
voxel-downsampled at 0.01, and the symmetric Chamfer distance runs on the
card (`--device cpu` on the CPU). The result is appended to `--log` in the
format of the repository's eval_synthetic_shape.py. The held-out views are
the `test` split for GlossySynthetic objects (`syn/<object>`) and the
`validation` split for the others (a procedural scene, `proc/<kind>/<res>`).
"""
import argparse
import os
from pathlib import Path

import numpy as np

from nero_tpu_torch.core.device import resolve_device
from nero_tpu_torch.dataset.database import (get_database_eval_points, get_database_split,
                                             parse_database_name, voxel_downsample)
from nero_tpu_torch.geometry.chamfer import chamfer_distance
from nero_tpu_torch.geometry.mesh_io import read_ply
from nero_tpu_torch.geometry.native import rasterize_depth
from nero_tpu_torch.utils.pose import mask_depth_to_pts, pose_apply, pose_inverse


def mesh_points_from_views(mesh, database, test_ids, voxel_size=0.01):
    verts = mesh["vertices"]
    tris = mesh["triangles"]
    pts_all = []
    for img_id in test_ids:
        K = database.get_K(img_id)
        pose = database.get_pose(img_id)
        h, w = database.get_image(img_id).shape[:2]
        verts_cam = pose_apply(pose, verts).astype(np.float32)
        depth = rasterize_depth(verts_cam, tris, K, h, w)
        pts_cam = mask_depth_to_pts(depth > 0, depth, K)
        pts_all.append(pose_apply(pose_inverse(pose), pts_cam))
    pts = np.concatenate(pts_all, 0).astype(np.float32)
    return voxel_downsample(pts, voxel_size)


def main(argv=None) -> dict:
    """Returns {'chamfer', 'pr_to_gt', 'gt_to_pr', 'message'}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--mesh", type=str, required=True)
    parser.add_argument("--object", type=str, required=True,
                        help="database name, e.g. syn/bell or proc/sphere/128_16")
    parser.add_argument("--log", type=str, default="data/geometry.log")
    parser.add_argument("--device", type=str, default=None, help="default: cuda")
    flags = parser.parse_args(argv)
    device = resolve_device(flags.device)

    database = parse_database_name(flags.object)
    gt_pts = get_database_eval_points(database)
    split = "test" if flags.object.startswith("syn") else "validation"
    _, test_ids = get_database_split(database, split)

    pr_pts = mesh_points_from_views(read_ply(flags.mesh), database, test_ids)
    chamfer, d01, d10 = chamfer_distance(pr_pts, gt_pts, device=device)
    msg = f"{Path(flags.mesh).stem} {chamfer:.6f} pr-to-gt {d01:.6f} gt-to-pr {d10:.6f}"
    print(msg)
    Path(os.path.dirname(flags.log) or ".").mkdir(exist_ok=True, parents=True)
    with open(flags.log, "a") as f:
        f.write(msg + "\n")
    return {"chamfer": float(chamfer), "pr_to_gt": float(d01), "gt_to_pr": float(d10),
            "message": msg}


if __name__ == "__main__":
    main()
