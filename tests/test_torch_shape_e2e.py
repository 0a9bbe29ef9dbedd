"""End-to-end Stage-I smoke test of the port on the procedural scene (CPU,
tiny shapes): the mirror of tests/test_shape_e2e.py, and the two other
Stage-I configurations (`configs/shape/proc/sphere_real.yaml`: the human
light of the real captures; `sphere_heads.yaml`: per-head shader through the
predictor function and the value-only SDF function) held against nero_tpu:
loss and every gradient at a step before and a step inside the occlusion
phase."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nero_tpu.ops.fg_lut import get_fg_lut as jax_fg_lut
from nero_tpu.render import shape as J
from nero_tpu.train.losses import compute_losses as jax_compute_losses, total_loss as jax_total
from nero_tpu_torch.core.config import load_cfg
from nero_tpu_torch.core.convert import from_numpy_tree, tree_items
from nero_tpu_torch.models.shape import NeROShapeModel
from nero_tpu_torch.render.rays import human_coordinate_poses
from nero_tpu_torch.train.trainer import Trainer

# one intra-op thread: the suite runs several worker processes side by side
torch.set_num_threads(1)

TINY_CFG = {
    "name": "test_tiny", "network": "shape", "database_name": "proc/sphere/32_6",
    "n_samples": 16, "n_importance": 8, "up_sample_steps": 2, "n_bg_samples": 4,
    "train_ray_num": 32, "test_ray_num": 64, "occ_loss_step": 5, "occ_loss_max_pn": 64,
    "anneal_end": 100, "test_downsample_ratio": True, "downsample_ratio": 0.5,
    "loss": ["nerf_render", "eikonal", "std", "init_sdf_reg", "occ"],
    "eikonal_weight": 0.1, "key_metric_name": "psnr",
}


@pytest.fixture(scope="module")
def model():
    m = NeROShapeModel(dict(TINY_CFG), training=True, device="cpu")
    opt = torch.optim.Adam(m.parameters(), lr=1e-3)
    losses = [float(m.train_step(opt, i)["loss_rgb"]) for i in range(8)]
    m.losses, m.opt = losses, opt
    return m


def test_train_step_runs_and_improves(model):
    assert all(np.isfinite(model.losses))
    assert np.mean(model.losses[-3:]) < np.mean(model.losses[:3]), model.losses


def test_log_contains_expected_keys(model):
    log = model.train_step(model.opt, 10)
    for k in ["loss_rgb", "loss_eikonal", "std", "loss_occ", "loss_sdf_small",
              "loss_sdf_large", "loss_total"]:
        assert k in log, f"missing {k}"
        assert np.isfinite(float(log[k])), k


def test_test_step_outputs(model):
    outputs = model.test_step(model.params, 0, step=10)
    h, w = outputs["ray_rgb"].shape[:2]
    assert outputs["gt_rgb"].shape == (h, w, 3)
    assert outputs["normal"].shape == (h, w, 3)
    assert outputs["depth"].shape == (h, w, 1)
    assert outputs["occ_prob_gt"].shape == (h, w, 1)
    for k in ["metallic", "roughness", "occ_prob"]:
        assert outputs[k].shape == (h, w, 1)
    assert np.isfinite(outputs["ray_rgb"]).all()


def test_nvs(model):
    pose = model.test_imgs_info["poses"][0]
    K = model.test_imgs_info["Ks"][0]
    img = model.nvs(model.params, pose, K, 16, 16, step=10)
    assert img.shape == (16, 16, 3)
    assert np.isfinite(img).all()


def test_trainer_runs_validates_and_resumes(tmp_path):
    cfg = {**TINY_CFG, "val_metric": ["shape_render"], "total_step": 3, "train_log_step": 1,
           "val_interval": 3, "save_interval": 2, "model_root": str(tmp_path),
           "vis_dir": str(tmp_path), "lr_cfg": {"end_warm": 1, "lr": 1e-3}}
    trainer = Trainer(dict(cfg), device="cpu")
    trainer.run()
    assert [h["step"] for h in trainer.train_history] == [0, 1, 2]
    assert np.isfinite(trainer.val_results["val-psnr"])
    assert (tmp_path / "test_tiny" / "model.npz").exists()
    resumed = Trainer({**cfg, "total_step": 4}, device="cpu")
    resumed.run()
    assert [h["step"] for h in resumed.train_history] == [3]


def test_trainer_writes_the_profile_trace(tmp_path):
    """`profile_dir` (nero_tpu's key and defaults): a torch.profiler Chrome
    trace of steps [profile_start, profile_start + profile_steps) and the span
    table of the same events beside it; a run without the key writes
    neither."""
    cfg = {**TINY_CFG, "val_metric": ["shape_render"], "total_step": 4, "train_log_step": 10,
           "val_interval": 10, "save_interval": 10, "lr_cfg": {"end_warm": 1, "lr": 1e-3}}
    assert Trainer(dict(cfg, model_root=str(tmp_path / "plain")), device="cpu").cfg[
        "profile_dir"] is None
    traced = tmp_path / "trace"
    Trainer({**cfg, "model_root": str(tmp_path / "model"), "vis_dir": str(tmp_path / "vis"),
             "profile_dir": str(traced), "profile_start": 1, "profile_steps": 2},
            device="cpu").run()
    assert sorted(p.name for p in traced.iterdir()) == ["test_tiny_steps1-2.spans.json",
                                                        "test_tiny_steps1-2.trace.json"]
    with open(traced / "test_tiny_steps1-2.trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert any(e.get("name") == "nero.step.forward" for e in events)
    with open(traced / "test_tiny_steps1-2.spans.json") as f:
        spans = json.load(f)
    assert spans["steps"] == 2 and spans["spans"]["nero.step"]["calls"] == 1.0
    assert spans["spans"]["nero.step.backward"]["aten_ops"] > 0
    Trainer({**cfg, "model_root": str(tmp_path / "plain"), "vis_dir": str(tmp_path / "vis2")},
            device="cpu").run()
    assert not list(tmp_path.glob("plain/**/*.json")) and not list(tmp_path.glob("*.json"))


def test_entry_points_need_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        NeROShapeModel(dict(TINY_CFG), training=False)


# ---------------------------------------------------------------------------
# the other Stage-I configurations against nero_tpu
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R = 32
# every masked candidate is selected in the occlusion loss, so the random
# scores (different generators in the two packages) drop out
PARITY_CFG = {**TINY_CFG, "perturb": 0.0, "occ_loss_max_pn": R * 24}


def _new_cfg(which: str) -> dict:
    """The network block of configs/shape/proc/sphere_<which>.yaml on the tiny
    sizes of TINY_CFG."""
    yaml_cfg = load_cfg(os.path.join(ROOT, "configs", "shape", "proc", f"sphere_{which}.yaml"))
    keys = ("shader_config", "use_fused_sdf")
    return {**PARITY_CFG, **{k: yaml_cfg[k] for k in keys if k in yaml_cfg}}


def test_new_config_files():
    real, heads = _new_cfg("real"), _new_cfg("heads")
    assert real["shader_config"] == {"human_light": True} and "use_fused_sdf" not in real
    assert heads["shader_config"] == {"fused_shader": False, "fused_heads": True}
    assert heads["use_fused_sdf"] is True
    # off the TPU nero_tpu resolves both kernel switches off: both sides run f32
    scfg_j = J.shape_config_from_dict(dict(heads))
    assert not scfg_j.use_fused_sdf and not scfg_j.shader.fused_heads
    scfg_t = NeROShapeModel(dict(heads), training=False, device="cpu").scfg
    assert scfg_t.use_fused_sdf and scfg_t.shader.fused_heads


def _parity_rays(model):
    """Rays aimed near the origin with the 'human' poses of the scene's own
    cameras (one camera per ray, round robin)."""
    rng = np.random.default_rng(0)
    o = rng.standard_normal((R, 3))
    o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + rng.uniform(-0.4, 0.4, (R, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    mid = -np.sum(o * d, -1, keepdims=True)
    rays = dict(rays_o=o, rays_d=d, near=np.maximum(mid - 1.0, 1e-3), far=mid + 1.0,
                rgb=rng.uniform(0, 1, (R, 3)))
    poses = human_coordinate_poses(model.train_data["poses"], model.cfg["fixed_camera"])
    rays["human_poses"] = poses[torch.arange(R) % poses.shape[0]].numpy()
    return {k: np.asarray(v, np.float32) for k, v in rays.items()}


@pytest.mark.parametrize("step", [3, 6], ids=["before_occ", "occ_phase"])
@pytest.mark.parametrize("which", ["real", "heads"])
def test_new_configs_loss_and_grads_match_jax(which, step):
    """Normalised as tests/test_torch_shape.py::test_train_step_loss_and_grads:
    each leaf by its max, or by 1e-2 of the step's largest gradient: 1e-3."""
    cfg = _new_cfg(which)
    scfg_j = J.shape_config_from_dict(dict(cfg))
    params_j = jax.tree_util.tree_map(
        np.asarray, J.init_shape_params(jax.random.PRNGKey(0), scfg_j))
    model = NeROShapeModel(dict(cfg), training=True, device="cpu")
    rays = _parity_rays(model)
    j = {k: jnp.asarray(v) for k, v in rays.items()}

    def loss_j(p):
        out = J.render(p, scfg_j, jnp.asarray(jax_fg_lut()), j["rays_o"], j["rays_d"],
                       j["near"], j["far"], j["human_poses"], step, key=jax.random.PRNGKey(0),
                       is_train=True, perturb_overwrite=0.0)
        out["loss_rgb"] = J.compute_rgb_loss(out["ray_rgb"], j["rgb"], "charbonier")
        return jax_total(jax_compute_losses(cfg["loss"], out, None, step, cfg))

    val_j, g_j = jax.jit(jax.value_and_grad(loss_j))(
        jax.tree_util.tree_map(jnp.asarray, params_j))
    model.params = from_numpy_tree(params_j)
    loss_t, log = model.loss_fn(model.params, {k: torch.from_numpy(v) for k, v in rays.items()},
                                step, gen=torch.Generator().manual_seed(0))
    loss_t.backward()
    assert (float(log["loss_occ"].detach()) > 0.0) == (step >= cfg["occ_loss_step"])
    np.testing.assert_allclose(loss_t.item(), float(val_j), rtol=1e-4)
    grads_j = list(tree_items(jax.tree_util.tree_map(np.asarray, g_j)))
    if which == "real":
        assert any(k.startswith("shader|human_light") for k, _ in grads_j)
    floor = 1e-2 * max(np.abs(a).max() for _, a in grads_j)
    got = dict(tree_items(model.params))
    assert set(got) == {k for k, _ in grads_j}
    for k, a in grads_j:
        b = got[k].grad
        b = np.zeros_like(a) if b is None else b.numpy()
        scale = max(np.abs(a).max(), floor)
        np.testing.assert_allclose(b / scale, a / scale, atol=1e-3, err_msg=k)


@pytest.mark.parametrize("which", ["real", "heads"])
def test_new_configs_train_and_validate(which):
    """A few optimizer steps (into the occlusion phase) and one validation
    view: the batches carry each camera's human pose; finite throughout."""
    cfg = {**_new_cfg(which), "perturb": 1.0, "occ_loss_max_pn": 64}
    m = NeROShapeModel(dict(cfg), training=True, device="cpu")
    assert m.train_data["human_poses"].shape == (len(m.train_ids), 3, 4)
    opt = torch.optim.Adam(m.parameters(), lr=1e-3)
    logs = [{k: float(v) for k, v in m.train_step(opt, i).items()} for i in range(3, 7)]
    assert all(np.isfinite(v) for log in logs for v in log.values())
    assert logs[-1]["loss_occ"] > 0.0
    outputs = m.test_step(m.params, 0, step=7)
    assert ("human_light" in outputs) == (which == "real")
    assert np.isfinite(outputs["ray_rgb"]).all() and np.isfinite(outputs["occ_prob_gt"]).all()


def test_fixed_camera_keeps_the_camera_height():
    """`fixed_camera` reaches the human poses of batches and validation rays."""
    a = NeROShapeModel({**TINY_CFG, "fixed_camera": False}, training=True, device="cpu")
    b = NeROShapeModel({**TINY_CFG, "fixed_camera": True}, training=True, device="cpu")
    ha, hb = a.train_data["human_poses"], b.train_data["human_poses"]
    torch.testing.assert_close(ha[..., :3], hb[..., :3])
    assert not torch.allclose(ha[..., 3], hb[..., 3])
    pose, K = a.test_imgs_info["poses"][0], a.test_imgs_info["Ks"][0]
    ra, rb = a._image_rays(K, pose, 4, 4), b._image_rays(K, pose, 4, 4)
    assert ra["human_poses"].shape == (16, 3, 4)
    assert not torch.allclose(ra["human_poses"], rb["human_poses"])
