"""The port's pipeline tools end to end on the CPU, in process (`--device
cpu`): `run_pipeline_demo` (Stage I -> mesh -> Chamfer -> Stage II through
the device BVH -> materials, bake, environment light), `run_real_pipeline`
(the `capture` scene exported as a custom object, then Stage I through its
COLMAP parse and crop cache, the mesh, Stage II) and `render_nvs`. Each
report holds the keys of the repository's tool (read from its source) for
the same flags, every figure finite. The scene that `export_scene` writes is
read by nero_tpu's CustomDatabase and by the port's to the same views, and
equals the one nero_tpu's exporter writes.

Sizes are the CPU's: Stage I takes 32-ray batches of 16 + 8 samples (the
published widths otherwise), Stage II's neural tracer distils 80 k samples
for 100 steps into a cache of its own, its grid fallback bakes 64^3."""
import ast
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import nero_tpu.dataset.database as JD
import nero_tpu_torch.dataset.database as TD
from nero_tpu_torch import render_nvs, run_pipeline_demo, run_real_pipeline
from nero_tpu_torch.geometry import grid_tracer, neural_tracer
from nero_tpu_torch.models import material, shape
from nero_tpu_torch.utils.image import imread

# one intra-op thread: the suite runs several worker processes side by side
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_SHAPE = {"train_ray_num": 32, "test_ray_num": 256, "n_samples": 16, "n_importance": 8,
               "up_sample_steps": 2, "n_bg_samples": 4}
SMALL_MATERIAL = {"train_ray_num": 32, "test_ray_num": 256, "tracer_distill_steps": 100}


def reference_keys(tool: str, tracers=()) -> set:
    """The keys that tools/<tool>.py stores in its report: every
    `report[...] = ...` of its source, an f-string key once per tracer."""
    tree = ast.parse(open(os.path.join(REPO, "tools", f"{tool}.py")).read())
    keys = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if not (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                    and t.value.id == "report"):
                continue
            if isinstance(t.slice, ast.Constant):
                keys.add(t.slice.value)
            elif isinstance(t.slice, ast.JoinedStr):
                for tracer in tracers:
                    keys.add("".join(v.value if isinstance(v, ast.Constant) else tracer
                                     for v in t.slice.values))
    return keys


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """CPU-sized defaults (the tools leave these keys to them) and a
    database root of the module's own."""
    mp = pytest.MonkeyPatch()
    mp.setattr(shape, "DEFAULT_SHAPE_CFG", {**shape.DEFAULT_SHAPE_CFG, **SMALL_SHAPE})
    mp.setattr(material, "DEFAULT_MATERIAL_CFG",
               {**material.DEFAULT_MATERIAL_CFG, **SMALL_MATERIAL})

    class SmallTracer(neural_tracer.NeuralTracer):
        CACHE_DIR = str(tmp_path_factory.mktemp("tracer_cache"))

        def __init__(self, vertices, triangles, **kw):
            kw.update(distill_samples=80_000, distill_batch=8192, verbose=False)
            super().__init__(vertices, triangles, **kw)

    class SmallGrid(grid_tracer.GridTracer):
        def __init__(self, vertices, triangles, **kw):
            super().__init__(vertices, triangles, res=64, **kw)

    SmallTracer.__name__, SmallGrid.__name__ = "NeuralTracer", "GridTracer"
    mp.setattr(neural_tracer, "NeuralTracer", SmallTracer)
    mp.setattr(grid_tracer, "GridTracer", SmallGrid)
    root = tmp_path_factory.mktemp("pipeline")
    mp.setattr(TD, "DATA_ROOT", str(root / "data"))
    mp.chdir(root)
    yield root
    mp.undo()


@pytest.fixture(scope="module")
def demo(small):
    return run_pipeline_demo.main(["--steps1", "4", "--steps2", "2", "--res", "32",
                                   "--mesh_res", "32", "--tracers2", "bvh", "--device", "cpu",
                                   "--out", "demo"])


@pytest.fixture(scope="module")
def real(small):
    return run_real_pipeline.main(["--steps1", "4", "--steps2", "2", "--views", "4", "--res",
                                   "48", "--max_len", "32", "--train_rays", "64", "--mesh_res",
                                   "32", "--device", "cpu", "--out", "demo_real"])


def _assert_report(report, path, keys):
    assert set(report) == keys
    assert all(np.isfinite(v) for v in report.values()), report
    with open(path) as f:
        assert json.load(f) == report


def test_demo_report(small, demo):
    keys = reference_keys("run_pipeline_demo", ["bvh"])
    assert "mesh_radius_mae" in keys and "stage2_psnr_bvh" in keys
    _assert_report(demo, small / "demo" / "report.json", keys)
    assert demo["mesh_verts"] > 100
    assert demo["stage2_psnr"] == demo["stage2_psnr_bvh"]
    assert 0.0 < demo["chamfer"] < 0.5 and demo["mesh_radius_mae"] == demo["mesh_sdf_mae"]


def test_demo_exports(small, demo):
    out = small / "demo"
    mats = {k: np.load(out / f"{k}.npy") for k in ("metallic", "roughness", "albedo")}
    n = demo["mesh_verts"]
    assert [v.shape for v in mats.values()] == [(n, 1), (n, 1), (n, 3)]
    assert all(np.isfinite(v).all() for v in mats.values())
    assert imread(str(out / "albedo.jpg")).shape == (256, 256, 3)
    assert imread(str(out / "env_light.png")).shape == (64, 128, 3)
    assert (out / "model" / "demo_material_bvh" / "model.npz").exists()


def test_real_pipeline_report(small, real):
    keys = reference_keys("run_real_pipeline")
    assert "chamfer_vs_object_cloud" in keys
    _assert_report(real, small / "demo_real" / "report.json", keys)
    assert real["mesh_verts"] > 100
    root = small / "data" / "custom" / "capture_sim"
    assert (root / "cache.pkl").exists() and (root / "images_32" / "meta_info.pkl").exists()
    assert imread(str(root / "images_32" / "001.png")).shape == (32, 32, 3)


def _reference_exporter():
    spec = importlib.util.spec_from_file_location(
        "reference_run_real_pipeline", os.path.join(REPO, "tools", "run_real_pipeline.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.export_scene


def test_export_is_the_reference_export(tmp_path, monkeypatch):
    """The port's export (under its database root) and nero_tpu's (under
    data/ of the working directory) write the same files."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(TD, "DATA_ROOT", str(tmp_path / "port"))
    port = run_real_pipeline.export_scene("cap", 40, 3)
    ref = _reference_exporter()("cap", 40, 3)
    assert port == str(tmp_path / "port" / "custom" / "cap") and ref == "data/custom/cap"
    names = sorted(os.path.relpath(os.path.join(d, f), port)
                   for d, _, fs in os.walk(port) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), ref)
                           for d, _, fs in os.walk(ref) for f in fs)
    assert len(names) == 3 + 2 + 2
    for name in names:
        with open(os.path.join(port, name), "rb") as a, open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("max_len", ["raw_40", "24"])
def test_export_read_by_both_packages(tmp_path, monkeypatch, max_len):
    """Each package reads its own copy of the port's export: the same
    images, K and poses."""
    monkeypatch.setattr(TD, "DATA_ROOT", str(tmp_path / "port"))
    run_real_pipeline.export_scene("cap", 40, 3)
    import shutil
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    monkeypatch.setattr(JD, "DATA_ROOT", str(tmp_path / "jax"))
    port = TD.parse_database_name(f"custom/cap/{max_len}")
    ref = JD.parse_database_name(f"custom/cap/{max_len}")
    assert port.get_img_ids() == ref.get_img_ids() == [1, 2, 3]
    for i in port.get_img_ids():
        np.testing.assert_array_equal(port.get_image(i), ref.get_image(i))
        np.testing.assert_array_equal(port.get_K(i), ref.get_K(i))
        np.testing.assert_array_equal(port.get_pose(i), ref.get_pose(i))
    np.testing.assert_array_equal(port.ref_points, ref.ref_points)


def test_render_nvs(small, demo):
    cfg = small / "nvs.yaml"
    cfg.write_text(f"name: demo_shape\nnetwork: shape\nmodel_root: {small / 'demo' / 'model'}\n")
    out = render_nvs.main(["--cfg", str(cfg), "--num_frames", "2", "--resolution", "16",
                           "--out", str(small / "nvs"), "--device", "cpu"])
    assert out["step"] == 4 and out["frames"].shape == (2, 16, 16, 3)
    for i in range(2):
        np.testing.assert_array_equal(imread(os.path.join(out["dir"], f"{i:04d}.png")),
                                      out["frames"][i])
    assert out["frames"].std() > 0
