"""Bake Stage-II materials into UV texture maps, with an OBJ/MTL export:

    python -m nero_tpu_torch.extract_materials_texture_map \
        --cfg configs/material/proc/bowl.yaml

A UV atlas of the mesh (normal-clustered charts, or one cell half per
triangle), the 3-D surface position of each texel rasterised in UV space on
the host, the material heads queried at those positions on the card
(`--device cpu` on the CPU) in batches, the roughness's square root,
nearest-neighbour inpainting of the seam gutter, then albedo / metallic /
roughness JPEGs and a textured OBJ/MTL in
<output_dir>/<name>-<step>/. Prefers model_best.npz where it exists; the
counterpart of the repository's extract_materials_texture_map.py.
"""
import argparse
import os
import time
from pathlib import Path

import numpy as np
import torch

from nero_tpu_torch.core.checkpoint import load_checkpoint
from nero_tpu_torch.core.config import load_cfg
from nero_tpu_torch.core.device import resolve_device
from nero_tpu_torch.geometry.native import rasterize_uv
from nero_tpu_torch.geometry.uv_atlas import (chart_atlas, export_mtl, export_obj, knn_inpaint,
                                              triangle_atlas)
from nero_tpu_torch.models.material import NeROMaterialModel
from nero_tpu_torch.utils.color import linear_to_srgb
from nero_tpu_torch.utils.image import imsave


def bake_textures(model, params, resolution: int = 1024, batch: int = 8192,
                  atlas: str = "charts", verbose: bool = True):
    """(albedo [r,r,3] sRGB, metallic [r,r,1], roughness [r,r,1], (uv,
    uv_tris, vert_map)), floats in [0, 1]."""
    verts, tris = model.vertices, model.triangles
    if atlas == "charts":
        uv, uv_tris, vert_map = chart_atlas(verts, tris, resolution=resolution)
    else:
        uv, uv_tris, vert_map = triangle_atlas(tris)
    pos_img, mask = rasterize_uv(uv, uv_tris, verts[vert_map], resolution, resolution)
    if verbose:
        print(f"[bake] atlas={atlas} uv_verts={len(uv)} texel_utilization={mask.mean():.3f}")
    pts = pos_img[mask]
    mats = np.zeros((len(pts), 5), np.float32)
    for i in range(0, len(pts), batch):
        mats[i:i + batch] = model.predict_materials_at(pts[i:i + batch], params)

    tex = np.zeros((resolution, resolution, 5), np.float32)
    tex[mask] = mats
    tex[..., 4][mask] = np.sqrt(np.maximum(tex[..., 4][mask], 1e-7))  # roughness sqrt
    tex = knn_inpaint(tex, mask)
    albedo = linear_to_srgb(torch.as_tensor(np.clip(tex[..., 0:3], 0, 1))).numpy()
    metallic = np.clip(tex[..., 3:4], 0, 1)
    roughness = np.clip(tex[..., 4:5], 0, 1)
    return albedo, metallic, roughness, (uv, uv_tris, vert_map)


def main(argv=None) -> dict:
    """Returns {'dir', 'step', 'albedo', 'metallic', 'roughness', 'bake_seconds'}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", type=str, required=True)
    parser.add_argument("--resolution", type=int, default=1024)
    parser.add_argument("--atlas", type=str, default="charts", choices=["charts", "per_triangle"])
    parser.add_argument("--output_dir", type=str, default="data/materials_texture")
    parser.add_argument("--device", type=str, default=None, help="default: cuda")
    flags = parser.parse_args(argv)
    device = resolve_device(flags.device)

    cfg = load_cfg(flags.cfg)
    model = NeROMaterialModel(cfg, training=False, device=device)
    model_dir = os.path.join(cfg.get("model_root", "data/model"), cfg["name"])
    ckpt_fn = os.path.join(model_dir, "model_best.npz")
    if not os.path.exists(ckpt_fn):
        ckpt_fn = os.path.join(model_dir, "model.npz")
    step, _ = load_checkpoint(ckpt_fn, model.params)
    print(f"loaded step {step} from {ckpt_fn}")

    t0 = time.perf_counter()
    albedo, metallic, roughness, (uv, uv_tris, vert_map) = bake_textures(
        model, model.params, flags.resolution, atlas=flags.atlas)
    bake_s = time.perf_counter() - t0

    out_dir = Path(flags.output_dir) / f"{cfg['name']}-{step}"
    out_dir.mkdir(exist_ok=True, parents=True)
    imsave(str(out_dir / "albedo.jpg"), (albedo * 255 + 0.5).astype(np.uint8))
    imsave(str(out_dir / "metallic.jpg"),
           (np.repeat(metallic, 3, -1) * 255 + 0.5).astype(np.uint8))
    imsave(str(out_dir / "roughness.jpg"),
           (np.repeat(roughness, 3, -1) * 255 + 0.5).astype(np.uint8))
    export_mtl(str(out_dir / "material.mtl"))
    export_obj(str(out_dir / "mesh.obj"), model.vertices, model.triangles,
               uv, uv_tris, vert_map, mtl_file="material.mtl")
    print(f"wrote textures + OBJ to {out_dir} (bake {bake_s:.3f} s)")
    return {"dir": str(out_dir), "step": step, "albedo": albedo, "metallic": metallic,
            "roughness": roughness, "bake_seconds": bake_s}


if __name__ == "__main__":
    main()
