"""Export per-vertex Stage-II materials as gamma-corrected .npy files:

    python -m nero_tpu_torch.extract_materials --cfg configs/material/proc/bowl.yaml

writes <output_dir>/<name>-<step>/{metallic,roughness,albedo}.npy, one row
per mesh vertex, with linear_to_srgb applied (the Blender vertex-colour
inverse-gamma workaround of the repository's extract_materials.py). Reads the
port's own checkpoint; runs on the card (`--device cpu` on the CPU).
"""
import argparse
import os
from pathlib import Path

import numpy as np
import torch

from nero_tpu_torch.core.checkpoint import load_checkpoint
from nero_tpu_torch.core.config import load_cfg
from nero_tpu_torch.core.device import resolve_device
from nero_tpu_torch.models.material import NeROMaterialModel
from nero_tpu_torch.utils.color import linear_to_srgb


def main(argv=None) -> dict:
    """Returns {'dir', 'step', 'materials'} (the arrays as written)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default="data/materials")
    parser.add_argument("--device", type=str, default=None, help="default: cuda")
    flags = parser.parse_args(argv)
    device = resolve_device(flags.device)

    cfg = load_cfg(flags.cfg)
    model = NeROMaterialModel(cfg, training=False, device=device)
    ckpt_fn = os.path.join(cfg.get("model_root", "data/model"), cfg["name"], "model.npz")
    step, _ = load_checkpoint(ckpt_fn, model.params)
    print(f"loaded step {step} from {ckpt_fn}")

    out_dir = Path(flags.output_dir) / f"{cfg['name']}-{step}"
    out_dir.mkdir(exist_ok=True, parents=True)
    materials = {k: linear_to_srgb(torch.as_tensor(v)).numpy()
                 for k, v in model.predict_materials().items()}
    for k, v in materials.items():
        np.save(str(out_dir / f"{k}.npy"), v)
    print(f"wrote materials to {out_dir}")
    return {"dir": str(out_dir), "step": step, "materials": materials}


if __name__ == "__main__":
    main()
