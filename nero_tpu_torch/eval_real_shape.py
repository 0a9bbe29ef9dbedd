"""Chamfer distance between two prepared point clouds (PLY) on the card:

    python -m nero_tpu_torch.eval_real_shape --pr pred.ply --gt gt.ply

(`--device cpu` on the CPU); the counterpart of the repository's
eval_real_shape.py (the CloudCompare workflow of eval.md).
"""
import argparse

from nero_tpu_torch.core.device import resolve_device
from nero_tpu_torch.geometry.chamfer import chamfer_distance
from nero_tpu_torch.geometry.mesh_io import read_ply


def main(argv=None) -> dict:
    """Returns {'chamfer', 'pr_to_gt', 'gt_to_pr'}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--pr", type=str, required=True, help="predicted point cloud (ply)")
    parser.add_argument("--gt", type=str, required=True, help="ground-truth point cloud (ply)")
    parser.add_argument("--device", type=str, default=None, help="default: cuda")
    flags = parser.parse_args(argv)
    device = resolve_device(flags.device)

    pr = read_ply(flags.pr)["vertices"]
    gt = read_ply(flags.gt)["vertices"]
    chamfer, d01, d10 = chamfer_distance(pr, gt, device=device)
    print(f"chamfer {chamfer:.6f} pr-to-gt {d01:.6f} gt-to-pr {d10:.6f}")
    return {"chamfer": float(chamfer), "pr_to_gt": float(d01), "gt_to_pr": float(d10)}


if __name__ == "__main__":
    main()
