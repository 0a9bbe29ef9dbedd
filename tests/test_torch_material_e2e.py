"""End-to-end Stage II of the port on the CPU: the mirror of
tests/test_material_e2e.py on the procedural sphere scene, with the neural
tracer at a small distillation (the march runs its plain version here), plus
the host precompute against nero_tpu's and every tracer / shader switch."""
import math

import numpy as np
import pytest
import torch

from nero_tpu.models.material import NeROMaterialModel as JaxMaterialModel
from nero_tpu_torch.geometry import neural_tracer
from nero_tpu_torch.geometry.proc_mesh import proc_mesh
from nero_tpu_torch.models import get_model
from nero_tpu_torch.models.material import DEFAULT_MATERIAL_CFG, NeROMaterialModel
from nero_tpu_torch.train.trainer import Trainer

# one intra-op thread: the suite runs several worker processes side by side
torch.set_num_threads(1)

MAT_CFG = {
    "name": "test_mat_tiny",
    "network": "material",
    "database_name": "proc/sphere/32_6",
    "train_ray_num": 32,
    "test_ray_num": 128,
    "shader_cfg": {
        "diffuse_sample_num": 32,
        "specular_sample_num": 16,
        "human_lights": False,
        "outer_light_version": "direction",
    },
    "loss": ["nerf_render", "mat_reg"],
    "val_metric": ["mat_render"],
    "key_metric_name": "psnr",
    "tracer": "neural",
    "tracer_distill_steps": 300,
}


class SmallTracer(neural_tracer.NeuralTracer):
    """The neural tracer at a CPU-sized distillation (120 k samples)."""

    def __init__(self, vertices, triangles, **kw):
        kw.update(distill_samples=120_000, distill_batch=16384, verbose=False)
        super().__init__(vertices, triangles, **kw)


@pytest.fixture(scope="module")
def small_tracer(tmp_path_factory):
    """Every model of this file distills small, into a cache of its own."""
    mp = pytest.MonkeyPatch()
    SmallTracer.CACHE_DIR = str(tmp_path_factory.mktemp("tracer_cache"))
    mp.setattr(neural_tracer, "NeuralTracer", SmallTracer)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def small_grid():
    """The grid tracer at a CPU-sized grid (64^3 instead of 256^3)."""
    from nero_tpu_torch.geometry import grid_tracer

    class SmallGrid(grid_tracer.GridTracer):
        def __init__(self, vertices, triangles, **kw):
            super().__init__(vertices, triangles, res=64, **kw)

    SmallGrid.__name__ = "GridTracer"
    mp = pytest.MonkeyPatch()
    mp.setattr(grid_tracer, "GridTracer", SmallGrid)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def sphere_mesh():
    return proc_mesh("sphere", grid=48, lo=-1.0, hi=1.0)


@pytest.fixture(scope="module")
def model(sphere_mesh, small_tracer):
    return NeROMaterialModel({**MAT_CFG, "mesh": sphere_mesh}, training=True, device="cpu")


def test_registry_and_defaults():
    assert get_model("material") is NeROMaterialModel
    from nero_tpu.models.material import DEFAULT_MATERIAL_CFG as JAX_DEFAULTS
    assert DEFAULT_MATERIAL_CFG == JAX_DEFAULTS


def test_hit_batch_on_surface(model):
    assert model.tbn > 100
    r = np.linalg.norm(model.train_batch["inters"], axis=-1)
    assert np.abs(r - 0.5).max() < 0.08
    # flipped normals point outward (NeuS-flip convention)
    n = model.train_batch["normals"]
    dots = np.sum(n * model.train_batch["inters"], -1) / np.maximum(r, 1e-9)
    assert (dots > 0.5).mean() > 0.95
    assert model.train_data["rays_o"].device.type == "cpu"
    assert model.train_data["human_poses"].shape == (model.tbn, 3, 4)


def test_host_precompute_matches_jax(model, sphere_mesh):
    """The hit store (same host library, same one-time shuffle) and the
    compaction capacities resolved from it are those of nero_tpu."""
    jm = JaxMaterialModel({**MAT_CFG, "mesh": sphere_mesh, "tracer": "bvh"}, training=True)
    assert jm.tbn == model.tbn
    assert set(jm.train_batch) == set(model.train_batch)
    for k, a in jm.train_batch.items():
        np.testing.assert_allclose(model.train_batch[k], a, atol=1e-6, err_msg=k)
    assert model.mcfg.inner_compact_frac == pytest.approx(jm.mcfg.inner_compact_frac, abs=1e-6)
    assert model.mcfg.outer_compact_frac == jm.mcfg.outer_compact_frac == 0.0
    assert model.mcfg.inner_compact_frac > 0.0        # convex scene: inner compaction on


def test_train_step_improves(model):
    opt = torch.optim.Adam(model.parameters(), lr=3e-4)
    losses = []
    for i in range(25):
        log = model.train_step(opt, i)
        losses.append(float(log["loss_rgb"]))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses


def test_log_keys(model):
    opt = torch.optim.Adam(model.parameters(), lr=3e-4)
    log = model.train_step(opt, 0)
    for k in ["loss_rgb", "loss_mat_reg", "loss_diffuse_light", "loss_total"]:
        assert k in log and np.isfinite(float(log[k])), k


def test_batch_is_drawn_on_the_device(model):
    a = model.sample_batch(torch.Generator().manual_seed(1))
    b = model.sample_batch(torch.Generator().manual_seed(1))
    assert set(a) == set(model.train_data)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["rays_o"].shape == (32, 3) and a["human_poses"].shape == (32, 3, 4)


def test_test_step(model):
    out = model.test_step(model.params, 0)
    h, w = out["rgb_pr"].shape[:2]
    assert out["rgb_pr"].shape == (h, w, 3)
    assert out["rgb_gt"].shape == (h, w, 3)
    assert out["roughness"].shape == (h, w, 1)
    assert np.isfinite(out["rgb_pr"]).all()
    # roughness exported in [0.04, 1] after sqrt
    rh = out["roughness"][out["roughness"] > 0]
    if rh.size:
        assert rh.min() >= 0.0399 and rh.max() <= 1.0001


def test_predict_materials_and_env(model):
    mats = model.predict_materials()
    nv = len(model.vertices)
    assert mats["metallic"].shape == (nv, 1)
    assert mats["roughness"].shape == (nv, 1)
    assert mats["albedo"].shape == (nv, 3)
    assert (mats["roughness"] >= 0.0399).all()
    env = model.env_light(8, 16)
    assert env.shape == (8, 16, 3) and np.isfinite(env).all()
    at = model.predict_materials_at(model.vertices[:7])
    assert at.shape == (7, 5) and np.isfinite(at).all()


def test_human_light_sphere_direction_step(sphere_mesh, small_tracer):
    """The other shader variant end to end: human light + sphere_direction."""
    cfg = {**MAT_CFG, "mesh": sphere_mesh,
           "shader_cfg": {**MAT_CFG["shader_cfg"], "human_lights": True,
                          "outer_light_version": "sphere_direction"}}
    m = NeROMaterialModel(cfg, training=True, device="cpu")
    assert "human_light" in m.params
    opt = torch.optim.Adam(m.parameters(), lr=3e-4)
    log = m.train_step(opt, 0)
    assert all(math.isfinite(float(v)) for v in log.values())
    assert any(g.grad is not None and g.grad.abs().max() > 0
               for g in m.parameters())


def test_trainer_runs_stage_two(sphere_mesh, small_tracer, tmp_path):
    """Trainer end to end on the CPU: steps, validation image, checkpoints."""
    cfg = {**MAT_CFG, "mesh": sphere_mesh, "total_step": 4, "val_interval": 4,
           "save_interval": 2, "train_log_step": 2, "model_root": str(tmp_path / "model"),
           "vis_dir": str(tmp_path / "vis")}
    trainer = Trainer(cfg, device="cpu")
    trainer.run()
    assert len(trainer.train_history) == 2
    assert math.isfinite(trainer.val_results["val-psnr"])
    assert (tmp_path / "model" / "test_mat_tiny" / "model.npz").exists()
    assert list((tmp_path / "vis").rglob("*.jpg"))


@pytest.mark.parametrize("override,exc", [
    ({"tracer": "grid"}, "GridTracer"),
    ({"tracer": "bvh"}, "RayTracer"),
    ({"tracer_field_topology": "wide"}, "SmallTracer"),
    ({"tracer_march_mode": "uniform"}, "SmallTracer"),
    ({"shader_cfg": {"fused_lights": True}}, "SmallTracer"),
    ({"tracer_rms_fallback": 1e-9}, "GridTracer"),
], ids=["grid", "bvh", "wide", "uniform", "fused_lights", "rms_fallback"])
def test_unported_options_raise(sphere_mesh, small_tracer, small_grid, override, exc, capsys):
    """Every one of these options is ported now: the model builds with the
    tracer the option names (`exc` is its class), traces through it, and a
    distill RMS above `tracer_rms_fallback` falls back to the grid tracer
    and says so."""
    cfg = {**MAT_CFG, "mesh": sphere_mesh, **override}
    cfg["shader_cfg"] = {**MAT_CFG["shader_cfg"], **override.get("shader_cfg", {})}
    m = NeROMaterialModel(cfg, training=False, device="cpu")
    assert type(m.ray_tracer).__name__ == exc
    said = "falling back to the grid tracer" in capsys.readouterr().out
    assert said == ("tracer_rms_fallback" in override)
    if exc == "SmallTracer":
        assert m.ray_tracer.field_topology == cfg.get("tracer_field_topology", "std")
        assert m.ray_tracer.march_mode == cfg.get("tracer_march_mode", "sphere")
    assert bool(m.mcfg.fused_lights) == ("shader_cfg" in override)
    # rays aimed at the centre from radius 0.9 hit the sphere at depth 0.4
    p = np.random.RandomState(1).normal(size=(64, 3))
    p /= np.linalg.norm(p, axis=-1, keepdims=True)
    o, d = torch.as_tensor(p * 0.9, dtype=torch.float32), torch.as_tensor(-p, dtype=torch.float32)
    inters, normals, depth, hit = m.trace_fn(o, d)
    assert hit.all() and (depth[:, 0] - 0.4).abs().max() < 0.03
    assert torch.sum(normals * d, -1).mean() > 0.9     # inward normals


def test_cuda_is_the_default_device(sphere_mesh):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NeROMaterialModel({**MAT_CFG, "mesh": sphere_mesh})


def test_bowl_config_is_the_published_width():
    from nero_tpu_torch.core.config import load_cfg
    cfg = load_cfg("configs/material/proc/bowl.yaml")
    ref = load_cfg("configs/material/syn/bell.yaml")
    assert cfg["shader_cfg"] == ref["shader_cfg"]
    assert cfg["network"] == "material" and cfg["database_name"] == "proc/bowl/100_12"
    for k in ("loss", "val_metric", "lr_cfg", "total_step", "optimizer_type", "lr_type"):
        assert cfg[k] == ref[k], k
