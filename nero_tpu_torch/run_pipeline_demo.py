"""The two-stage pipeline end to end on a procedural scene (no data needed):

    python -m nero_tpu_torch.run_pipeline_demo [--steps1 N] [--steps2 N] \
        [--scene sphere|bowl|mirror|capture] [--tracers2 neural,grid,bvh] [--out DIR]

Stage-I training -> mesh extraction -> Chamfer evaluation -> Stage-II
training (once per visibility backend of `--tracers2`) -> per-vertex
materials, a 256^2 texture bake and the environment light. `--scene capture`
turns on the real-capture switches: the camera-collocated human light in
Stage I, `human_lights` with the `sphere_direction` outer light in Stage II.
Runs on the card (`--device cpu` on the CPU). Writes the report (the keys of
the repository's tools/run_pipeline_demo.py) to <out>/report.json and
returns it.
"""
import argparse
import json
import os
import time

import numpy as np

from nero_tpu_torch.core.device import resolve_device
from nero_tpu_torch.dataset.database import get_database_eval_points, parse_database_name
from nero_tpu_torch.dataset.synthetic import scene_sdf
from nero_tpu_torch.extract_materials_texture_map import bake_textures
from nero_tpu_torch.fields.sdf import sdf_value
from nero_tpu_torch.geometry.chamfer import chamfer_distance
from nero_tpu_torch.geometry.isosurface import extract_geometry
from nero_tpu_torch.geometry.mesh_io import write_ply
from nero_tpu_torch.train.trainer import Trainer
from nero_tpu_torch.utils.color import color_map_backward
from nero_tpu_torch.utils.image import compute_psnr, imsave


def stage1_psnr(trainer, params, step: int) -> float:
    out = trainer.model.test_step(params, 0, step=step)
    return round(compute_psnr(color_map_backward(out["gt_rgb"]),
                              color_map_backward(out["ray_rgb"])), 2)


def stage2_psnr(trainer, params) -> float:
    out = trainer.model.test_step(params, 0)
    return round(compute_psnr(color_map_backward(out["rgb_gt"]),
                              color_map_backward(out["rgb_pr"])), 2)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps1", type=int, default=2000)
    parser.add_argument("--steps2", type=int, default=1000)
    parser.add_argument("--res", type=int, default=100)
    parser.add_argument("--mesh_res", type=int, default=128)
    parser.add_argument("--out", type=str, default="data/demo")
    parser.add_argument("--scene", type=str, default="sphere",
                        choices=["sphere", "bowl", "mirror", "capture"])
    parser.add_argument("--mesh_method", type=str, default="surface_nets",
                        choices=["surface_nets", "marching_tets"])
    parser.add_argument("--tracers2", type=str, default="neural",
                        help="comma list of Stage-II visibility backends to "
                             "compare (neural,grid,bvh)")
    # production cadences for full-length runs (configs/shape/syn/*.yaml:
    # val 5000 / ckpt 1000; configs/material/syn/*.yaml: val 5000 / ckpt
    # 500). 0 = validate once, at the end
    parser.add_argument("--val_interval1", type=int, default=0)
    parser.add_argument("--save_interval1", type=int, default=0)
    parser.add_argument("--val_interval2", type=int, default=0)
    parser.add_argument("--save_interval2", type=int, default=0)
    parser.add_argument("--device", type=str, default=None, help="default: cuda")
    flags = parser.parse_args(argv)
    device = resolve_device(flags.device)

    os.makedirs(flags.out, exist_ok=True)
    db = f"proc/{flags.scene}/{flags.res}_12"
    report = {}

    # ---------------- Stage I ----------------
    t0 = time.time()
    cfg1 = {
        "name": "demo_shape", "network": "shape", "database_name": db,
        "total_step": flags.steps1,
        "val_interval": flags.val_interval1 or flags.steps1,
        "save_interval": flags.save_interval1 or max(flags.steps1 // 2, 1),
        "train_log_step": 100,
        "lr_cfg": {"end_warm": 200, "end_iter": flags.steps1},
        "occ_loss_step": flags.steps1 // 2, "anneal_end": flags.steps1 // 4,
        "freeze_inv_s_step": flags.steps1 // 10,
        "loss": ["nerf_render", "eikonal", "std", "init_sdf_reg", "occ"],
        "val_metric": ["shape_render"], "key_metric_name": "psnr",
        "eikonal_weight": 0.1, "model_root": f"{flags.out}/model",
        "vis_dir": f"{flags.out}/train_vis", "downsample_ratio": 0.5,
    }
    # 'capture' is lit by a camera-collocated point light, the situation the
    # human_light head models (configs/shape/real/bear.yaml)
    if flags.scene == "capture":
        cfg1["shader_config"] = {"human_light": True}
    trainer1 = Trainer(cfg1, device=device)
    params1 = trainer1.run()
    report["stage1_seconds"] = round(time.time() - t0, 1)
    report["stage1_psnr"] = stage1_psnr(trainer1, params1, flags.steps1)

    # ---------------- mesh extraction + eval ----------------
    scfg = trainer1.model.scfg
    t0 = time.time()
    verts, tris = extract_geometry(
        [-1.01, -1.01, -1.01], [1.01, 1.01, 1.01], flags.mesh_res, 0.0,
        lambda p: sdf_value(params1["sdf"], p, scfg.sdf_cfg),
        method=flags.mesh_method, device=device)
    print(f"[run_pipeline_demo] mesh at {flags.mesh_res}^3: {len(verts)} vertices in "
          f"{time.time() - t0:.3f} s")
    mesh_path = f"{flags.out}/demo_shape-{flags.steps1}.ply"
    write_ply(mesh_path, verts, tris)
    report["mesh_verts"] = int(len(verts))

    # the evaluation cloud from a denser view set of the same scene (256 px x
    # 24 views, voxel 0.005): a 0.02 voxel floors the Chamfer distance near
    # 0.016, which hides real geometry gains
    gt_pts = get_database_eval_points(parse_database_name(f"proc/{flags.scene}/256_24"),
                                      voxel_size=0.005)
    chamfer, _, _ = chamfer_distance(verts, gt_pts, device=device)
    report["chamfer"] = round(float(chamfer), 5)
    # analytic truth: distance of the mesh's vertices to the scene's exact SDF
    report["mesh_sdf_mae"] = round(float(np.abs(scene_sdf(flags.scene)(verts)).mean()), 5)
    if flags.scene == "sphere":
        r = np.linalg.norm(verts, axis=-1)
        report["mesh_radius_mae"] = round(float(np.abs(r - 0.5).mean()), 5)

    # ---------------- Stage II (per visibility backend) ----------------
    tracers = flags.tracers2.split(",")
    trainer2 = params2 = None
    for tracer in tracers:
        t0 = time.time()
        cfg2 = {
            "name": f"demo_material_{tracer}", "network": "material",
            "database_name": db,
            "mesh": mesh_path, "total_step": flags.steps2, "tracer": tracer,
            "val_interval": flags.val_interval2 or flags.steps2,
            "save_interval": flags.save_interval2 or max(flags.steps2 // 2, 1),
            "train_log_step": 100,
            "lr_cfg": {"end_warm": 100, "end_iter": flags.steps2},
            "shader_cfg": {"diffuse_sample_num": 128, "specular_sample_num": 64,
                           # the GlossyReal material deltas
                           # (configs/material/real/bear.yaml) on 'capture'
                           "human_lights": flags.scene == "capture",
                           "outer_light_version": ("sphere_direction"
                                                   if flags.scene == "capture"
                                                   else "direction")},
            "loss": ["nerf_render", "mat_reg"], "val_metric": ["mat_render"],
            "key_metric_name": "psnr", "model_root": f"{flags.out}/model",
            "vis_dir": f"{flags.out}/train_vis",
        }
        trainer2 = Trainer(cfg2, device=device)
        params2 = trainer2.run()
        report[f"stage2_seconds_{tracer}"] = round(time.time() - t0, 1)
        report[f"stage2_psnr_{tracer}"] = stage2_psnr(trainer2, params2)
    report["stage2_psnr"] = report[f"stage2_psnr_{tracers[0]}"]

    # ---------------- exports ----------------
    mats = trainer2.model.predict_materials(params2)
    for k in ("metallic", "roughness", "albedo"):
        np.save(f"{flags.out}/{k}.npy", mats[k])
    albedo, _, _, _ = bake_textures(trainer2.model, params2, resolution=256)
    imsave(f"{flags.out}/albedo.jpg", (albedo * 255 + 0.5).astype(np.uint8))
    env = trainer2.model.env_light(64, 128, params2)
    imsave(f"{flags.out}/env_light.png", (np.clip(env, 0, 1) * 255 + 0.5).astype(np.uint8))

    print(json.dumps(report, indent=2))
    with open(f"{flags.out}/report.json", "w") as f:
        json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
