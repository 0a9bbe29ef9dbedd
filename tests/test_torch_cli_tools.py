"""The port's entry points end to end on the CPU, in process (`--device cpu`):
train Stage I on a tiny procedural configuration, extract its mesh,
evaluate it by Chamfer, train Stage II on that mesh, export its per-vertex
materials and bake its texture maps; the counterpart of
tests/test_cli_tools.py. And every entry point (the pipeline tools and
render_nvs too), called without `--device` on a machine without CUDA,
raises instead of running on the CPU, before it reads or writes anything."""
import os

import numpy as np
import pytest
import torch

from nero_tpu_torch import (eval_real_shape, eval_synthetic_shape, extract_materials,
                            extract_materials_texture_map, extract_mesh, render_nvs,
                            run_pipeline_demo, run_real_pipeline, run_training)
from nero_tpu_torch.geometry.mesh_io import read_ply, write_ply

# one intra-op thread: the suite runs several worker processes side by side
torch.set_num_threads(1)

SHAPE_CFG = """\
name: cli_tiny
network: shape
database_name: proc/sphere/32_6
n_samples: 16
n_importance: 8
up_sample_steps: 2
n_bg_samples: 4
train_ray_num: 32
test_ray_num: 64
occ_loss_step: 100000
anneal_end: 100
total_step: 4
val_interval: 4
save_interval: 2
train_log_step: 2
loss: ['nerf_render','eikonal','std','init_sdf_reg','occ']
val_metric: ['shape_render']
key_metric_name: psnr
lr_type: warm_up_cos
lr_cfg: {end_warm: 2, end_iter: 4}
optimizer_type: adam
"""

# Stage II on the extracted mesh, traced by the device BVH traversal (no
# distillation, no grid bake)
MATERIAL_CFG = """\
name: cli_tiny_material
network: material
database_name: proc/sphere/32_6
mesh: {mesh}
tracer: bvh
train_ray_num: 32
test_ray_num: 128
shader_cfg: {{diffuse_sample_num: 32, specular_sample_num: 16, human_lights: false,
             outer_light_version: direction}}
loss: ['nerf_render','mat_reg']
val_metric: ['mat_render']
key_metric_name: psnr
total_step: 2
val_interval: 2
save_interval: 2
train_log_step: 1
"""


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Stage I -> mesh -> Stage II -> materials, in a directory of its own."""
    root = tmp_path_factory.mktemp("cli_chain")
    mp = pytest.MonkeyPatch()
    mp.chdir(root)
    try:
        shape_cfg = root / "tiny.yaml"
        shape_cfg.write_text(SHAPE_CFG)
        run_training.main(["--cfg", str(shape_cfg), "--device", "cpu"])
        assert (root / "data/model/cli_tiny/model.npz").exists()
        mesh = extract_mesh.main(["--cfg", str(shape_cfg), "--resolution", "48",
                                  "--device", "cpu"])
        mat_cfg = root / "tiny_material.yaml"
        mat_cfg.write_text(MATERIAL_CFG.format(mesh=mesh["path"]))
        run_training.main(["--cfg", str(mat_cfg), "--device", "cpu"])
        materials = extract_materials.main(["--cfg", str(mat_cfg), "--device", "cpu"])
        textures = extract_materials_texture_map.main(
            ["--cfg", str(mat_cfg), "--resolution", "64", "--device", "cpu"])
        yield {"root": root, "mesh": mesh, "materials": materials, "textures": textures}
    finally:
        mp.undo()


def test_mesh_of_the_trained_sdf(chain):
    mesh = chain["mesh"]
    assert mesh["path"] == os.path.join("data/meshes", "cli_tiny-4.ply")
    verts = read_ply(str(chain["root"] / mesh["path"]))["vertices"]
    np.testing.assert_array_equal(verts, mesh["vertices"])
    # the barely-trained SDF is still roughly the geometric-init sphere
    assert len(verts) > 100
    assert 0.2 < np.median(np.linalg.norm(verts, axis=-1)) < 0.9
    assert mesh["grid_seconds"] > 0 and mesh["surface_seconds"] > 0


def test_eval_synthetic_shape(chain, capsys, monkeypatch):
    monkeypatch.chdir(chain["root"])
    out = eval_synthetic_shape.main(["--mesh", chain["mesh"]["path"],
                                     "--object", "proc/sphere/32_6", "--device", "cpu"])
    assert "pr-to-gt" in capsys.readouterr().out
    assert np.isfinite([out["chamfer"], out["pr_to_gt"], out["gt_to_pr"]]).all()
    log = (chain["root"] / "data/geometry.log").read_text().splitlines()
    assert log[-1] == out["message"] and log[-1].startswith("cli_tiny-4 ")


def test_eval_real_shape(chain, tmp_path):
    verts = chain["mesh"]["vertices"]
    write_ply(str(tmp_path / "pr.ply"), verts)
    write_ply(str(tmp_path / "gt.ply"), verts + np.float32([0.01, 0, 0]))
    out = eval_real_shape.main(["--pr", str(tmp_path / "pr.ply"),
                                "--gt", str(tmp_path / "gt.ply"), "--device", "cpu"])
    assert 0.0 < out["chamfer"] <= 0.0101


def test_stage_two_materials_on_the_extracted_mesh(chain):
    mats = chain["materials"]
    assert mats["step"] == 2
    n = len(chain["mesh"]["vertices"])
    for k, width in (("metallic", 1), ("roughness", 1), ("albedo", 3)):
        v = mats["materials"][k]
        assert v.shape == (n, width), k
        assert np.isfinite(v).all() and v.min() >= 0 and v.max() <= 1, k
        np.testing.assert_array_equal(np.load(os.path.join(chain["root"], mats["dir"],
                                                           f"{k}.npy")), v)


def test_texture_maps_of_the_extracted_mesh(chain):
    tex = chain["textures"]
    out_dir = chain["root"] / tex["dir"]
    for name in ("albedo.jpg", "metallic.jpg", "roughness.jpg", "material.mtl", "mesh.obj"):
        assert (out_dir / name).exists(), name
    for k in ("albedo", "metallic", "roughness"):
        v = tex[k]
        assert v.shape[:2] == (64, 64) and np.isfinite(v).all(), k
        assert v.min() >= 0 and v.max() <= 1, k
    lines = (out_dir / "mesh.obj").read_text().splitlines()
    assert sum(l.startswith("v ") for l in lines) == len(chain["mesh"]["vertices"])
    assert sum(l.startswith("f ") for l in lines) == len(chain["mesh"]["triangles"])


@pytest.mark.parametrize("module, argv", [
    (run_training, ["--cfg", "configs/shape/proc/sphere.yaml"]),
    (extract_mesh, ["--cfg", "configs/shape/proc/sphere.yaml"]),
    (eval_synthetic_shape, ["--mesh", "m.ply", "--object", "proc/sphere/32_6"]),
    (eval_real_shape, ["--pr", "a.ply", "--gt", "b.ply"]),
    (extract_materials, ["--cfg", "configs/material/proc/bowl.yaml"]),
    (extract_materials_texture_map, ["--cfg", "configs/material/proc/bowl.yaml"]),
    (run_pipeline_demo, ["--steps1", "4"]),
    (run_real_pipeline, ["--steps1", "4"]),
    (render_nvs, ["--cfg", "configs/shape/proc/sphere.yaml"]),
    (eval_synthetic_shape, ["--mesh", "m.ply", "--object", "syn/bell"]),
], ids=lambda x: getattr(x, "__name__", "").rsplit(".", 1)[-1] or None)
def test_entry_points_need_cuda_unless_told_otherwise(module, argv, monkeypatch):
    monkeypatch.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv)
