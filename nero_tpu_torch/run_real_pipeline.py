"""The real-capture pipeline end to end on a scene written in the on-disk
format of a custom object:

    python -m nero_tpu_torch.run_real_pipeline [--steps1 N] [--steps2 N] \
        [--views N] [--res N] [--max_len N] [--out DIR]

  1. `export_scene` renders the procedural `capture` scene (lit by a
     camera-collocated light, the regime of the human_light head) and writes
     it as a custom object under the database root
     (dataset/database.py::DATA_ROOT, set by NERO_TPU_DATA_ROOT):
       custom/<name>/images/<i>.png          rendered views
       custom/<name>/colmap/sparse/0/*.bin   the COLMAP sparse model
       custom/<name>/object_point_cloud.ply  fused depth points
       custom/<name>/meta_info.txt           up / forward rows
  2. Stage I trains through `custom/<name>/<max_len>` (COLMAP parse ->
     unit-sphere normalisation -> object-centred crop cache) with the
     GlossyReal shape delta, human_light.
  3. The mesh is extracted, mapped back through the database's recorded
     normalisation and scored against the scene's analytic SDF, and by
     Chamfer against the normalised object cloud.
  4. Stage II trains with the GlossyReal material deltas: the
     sphere_direction outer light and human_lights.
Runs on the card (`--device cpu` on the CPU). Writes the report (the keys of
the repository's tools/run_real_pipeline.py) to <out>/report.json and
returns it.
"""
import argparse
import json
import os
import shutil
import time

import numpy as np

import nero_tpu_torch.dataset.database as dbmod
from nero_tpu_torch.core.device import resolve_device
from nero_tpu_torch.dataset.colmap_model import Camera, Image, rotmat2qvec, write_model
from nero_tpu_torch.dataset.synthetic import scene_sdf
from nero_tpu_torch.fields.sdf import sdf_value
from nero_tpu_torch.geometry.chamfer import chamfer_distance
from nero_tpu_torch.geometry.isosurface import extract_geometry
from nero_tpu_torch.geometry.mesh_io import write_ply
from nero_tpu_torch.run_pipeline_demo import stage1_psnr, stage2_psnr
from nero_tpu_torch.train.trainer import Trainer
from nero_tpu_torch.utils.image import imsave


def export_scene(name: str, res: int, views: int, fresh: bool = True) -> str:
    """Render proc/capture and write it as the custom object <name> under
    the database root; returns the object's directory."""
    root = f"{dbmod.DATA_ROOT}/custom/{name}"
    if fresh and os.path.exists(root):
        shutil.rmtree(root)  # drop stale parse and crop caches
    os.makedirs(f"{root}/images", exist_ok=True)

    db = dbmod.parse_database_name(f"proc/capture/{res}_{views}")
    cameras, images = {}, {}
    for i, img_id in enumerate(db.get_img_ids(), start=1):
        img_name = f"{int(img_id):03d}.png"
        imsave(f"{root}/images/{img_name}", db.get_image(img_id))
        K = db.get_K(img_id)
        pose = db.get_pose(img_id)  # [R|t] world-to-camera, COLMAP's convention
        cameras[i] = Camera(id=i, model="PINHOLE", width=res, height=res,
                            params=np.asarray([K[0, 0], K[1, 1], K[0, 2], K[1, 2]],
                                              np.float64))
        images[i] = Image(id=i, qvec=rotmat2qvec(pose[:, :3]),
                          tvec=pose[:, 3].astype(np.float64), camera_id=i, name=img_name)
    write_model(cameras, images, f"{root}/colmap/sparse/0")

    # the object point cloud: a capture's is segmented MVS points; here the
    # fused rendered-depth points of the same views
    pts = dbmod.get_database_eval_points(db, voxel_size=0.01)
    write_ply(f"{root}/object_point_cloud.ply", pts.astype(np.float32))

    # meta_info.txt rows: up, forward (dataset/database.py::CustomDatabase)
    np.savetxt(f"{root}/meta_info.txt", np.asarray([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]]))
    return root


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps1", type=int, default=30000)
    parser.add_argument("--steps2", type=int, default=2500)
    parser.add_argument("--views", type=int, default=16)
    parser.add_argument("--res", type=int, default=300)
    parser.add_argument("--max_len", type=int, default=256)
    parser.add_argument("--mesh_res", type=int, default=128)
    parser.add_argument("--name", type=str, default="capture_sim")
    parser.add_argument("--out", type=str, default="data/demo_real")
    parser.add_argument("--train_rays", type=int, default=512)
    parser.add_argument("--device", type=str, default=None, help="default: cuda")
    flags = parser.parse_args(argv)
    device = resolve_device(flags.device)

    os.makedirs(flags.out, exist_ok=True)
    report = {}

    t0 = time.time()
    export_scene(flags.name, flags.res, flags.views)
    report["export_seconds"] = round(time.time() - t0, 1)
    db_name = f"custom/{flags.name}/{flags.max_len}"

    # ---------------- Stage I (GlossyReal shape deltas) ----------------
    t0 = time.time()
    cfg1 = {
        "name": "real_shape", "network": "shape", "database_name": db_name,
        "total_step": flags.steps1, "val_interval": flags.steps1,
        "save_interval": max(flags.steps1 // 2, 1), "train_log_step": 100,
        "lr_cfg": {"end_warm": 200, "end_iter": flags.steps1},
        "occ_loss_step": flags.steps1 // 2, "anneal_end": flags.steps1 // 4,
        "freeze_inv_s_step": flags.steps1 // 10,
        "loss": ["nerf_render", "eikonal", "std", "init_sdf_reg", "occ"],
        "val_metric": ["shape_render"], "key_metric_name": "psnr",
        "eikonal_weight": 0.1, "model_root": f"{flags.out}/model",
        "vis_dir": f"{flags.out}/train_vis", "train_ray_num": flags.train_rays,
        "downsample_ratio": 0.25,
        # the GlossyReal shape delta (configs/shape/real/bear.yaml)
        "shader_config": {"human_light": True},
    }
    trainer1 = Trainer(cfg1, device=device)
    params1 = trainer1.run()
    report["stage1_seconds"] = round(time.time() - t0, 1)
    report["stage1_psnr"] = stage1_psnr(trainer1, params1, flags.steps1)

    # ---------------- mesh extraction + analytic geometry eval ----------
    scfg = trainer1.model.scfg
    t0 = time.time()
    verts, tris = extract_geometry(
        [-1.01] * 3, [1.01] * 3, flags.mesh_res, 0.0,
        lambda p: sdf_value(params1["sdf"], p, scfg.sdf_cfg), device=device)
    print(f"[run_real_pipeline] mesh at {flags.mesh_res}^3: {len(verts)} vertices in "
          f"{time.time() - t0:.3f} s")
    mesh_path = f"{flags.out}/real_shape-{flags.steps1}.ply"
    write_ply(mesh_path, verts, tris)
    report["mesh_verts"] = int(len(verts))

    # map the vertices back through the database's recorded normalisation
    # (world' = R_rect (scale (world + offset))), score against the analytic SDF
    db = trainer1.model.database
    world = (np.asarray(verts) @ db.R_rect) / db.scale_rect - db.offset_rect
    report["mesh_sdf_mae"] = round(
        float(np.abs(scene_sdf("capture")(world.astype(np.float32))).mean()), 5)
    gt_pts = np.asarray(db.ref_points, np.float32)  # the normalised object cloud
    chamfer, _, _ = chamfer_distance(np.asarray(verts, np.float32), gt_pts, device=device)
    report["chamfer_vs_object_cloud"] = round(float(chamfer), 5)

    # ---------------- Stage II (GlossyReal material deltas) -------------
    t0 = time.time()
    cfg2 = {
        "name": "real_material", "network": "material", "database_name": db_name,
        "mesh": mesh_path, "total_step": flags.steps2, "tracer": "neural",
        "val_interval": flags.steps2, "save_interval": max(flags.steps2 // 2, 1),
        "train_log_step": 100,
        "lr_cfg": {"end_warm": 100, "end_iter": flags.steps2},
        "shader_cfg": {"diffuse_sample_num": 128, "specular_sample_num": 64,
                       # configs/material/real/bear.yaml
                       "human_lights": True,
                       "outer_light_version": "sphere_direction"},
        "loss": ["nerf_render", "mat_reg"], "val_metric": ["mat_render"],
        "key_metric_name": "psnr", "model_root": f"{flags.out}/model",
        "vis_dir": f"{flags.out}/train_vis", "train_ray_num": flags.train_rays,
        "downsample_ratio": 0.25,
    }
    trainer2 = Trainer(cfg2, device=device)
    params2 = trainer2.run()
    report["stage2_seconds"] = round(time.time() - t0, 1)
    report["stage2_psnr"] = stage2_psnr(trainer2, params2)

    print(json.dumps(report, indent=2))
    with open(f"{flags.out}/report.json", "w") as f:
        json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
