"""Render a novel-view orbit of a trained Stage-I model:

    python -m nero_tpu_torch.render_nvs --cfg configs/shape/proc/sphere.yaml

Reads the port's own checkpoint (<model_root>/<name>/model.npz) and renders
`--num_frames` views on a circle around the object, on the card (`--device
cpu` on the CPU), to <out>/<name>/<i>.png for qualitative inspection. Same
flags and artefacts as the repository's tools/render_nvs.py.
"""
import argparse
import os
from pathlib import Path

import numpy as np

from nero_tpu_torch.core.checkpoint import load_checkpoint
from nero_tpu_torch.core.config import load_cfg
from nero_tpu_torch.core.device import resolve_device
from nero_tpu_torch.models.shape import NeROShapeModel
from nero_tpu_torch.utils.image import imsave
from nero_tpu_torch.utils.pose import look_at_pose


def main(argv=None) -> dict:
    """Returns {'dir', 'step', 'frames'} (frames: the [n, res, res, 3] uint8 images)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", type=str, required=True)
    parser.add_argument("--num_frames", type=int, default=60)
    parser.add_argument("--resolution", type=int, default=256)
    parser.add_argument("--elevation", type=float, default=0.35)
    parser.add_argument("--distance", type=float, default=3.0)
    parser.add_argument("--out", type=str, default="data/nvs")
    parser.add_argument("--device", type=str, default=None, help="default: cuda")
    flags = parser.parse_args(argv)
    device = resolve_device(flags.device)

    cfg = load_cfg(flags.cfg)
    model = NeROShapeModel(cfg, training=False, device=device)
    ckpt = os.path.join(cfg.get("model_root", "data/model"), cfg["name"], "model.npz")
    step, _ = load_checkpoint(ckpt, model.params)
    print(f"loaded step {step}")

    res = flags.resolution
    f = 1.1 * res
    K = np.asarray([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1]], np.float32)
    out_dir = Path(flags.out) / cfg["name"]
    out_dir.mkdir(exist_ok=True, parents=True)
    frames = []
    for i in range(flags.num_frames):
        az = 2 * np.pi * i / flags.num_frames
        eye = flags.distance * np.asarray([
            np.cos(az) * np.cos(flags.elevation),
            np.sin(az) * np.cos(flags.elevation),
            np.sin(flags.elevation)])
        pose = look_at_pose(eye, np.zeros(3))
        img = model.nvs(model.params, pose, K, res, res, step=step)
        frames.append((np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8))
        imsave(str(out_dir / f"{i:04d}.png"), frames[-1])
        print(f"frame {i + 1}/{flags.num_frames}", end="\r")
    print(f"\nwrote {flags.num_frames} frames to {out_dir}")
    return {"dir": str(out_dir), "step": step, "frames": np.stack(frames)}


if __name__ == "__main__":
    main()
