"""Training steps of both stages at the TPU kernels' other encoding widths
against nero_tpu on the CPU, at small sizes: Stage I on the network block of
configs/shape/proc/sphere_enc.yaml (multires 8, the value-only SDF switch,
IDE degree 4 and light PE 10), Stage II on the shading block of
configs/material/proc/bowl_enc.yaml (both light heads through the light
kernel's wrapper at IDE degree 4). On the CPU every wrapper runs its plain
version; on the card chip_smoke.py's phase 11 trains both configurations
through the kernels."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nero_tpu.fields import mc_shading as J
from nero_tpu.ops.fg_lut import get_fg_lut as jax_fg_lut
from nero_tpu.render import shape as JR
from nero_tpu.train.losses import compute_losses as jax_compute_losses, total_loss as jax_total
from nero_tpu_torch.core.config import load_cfg
from nero_tpu_torch.core.convert import from_numpy_tree, tree_items
from nero_tpu_torch.fields import mc_shading as T
from nero_tpu_torch.models.shape import NeROShapeModel
from test_torch_mc_shading import _cfgs, _grad_close, _points, _torch_grads, trace_j, trace_t
from test_torch_shape_e2e import PARITY_CFG, ROOT, _parity_rays

torch.set_num_threads(1)


def _enc_cfg() -> dict:
    """sphere_enc.yaml's keys on the tiny sizes of the Stage-I parity test."""
    yaml_cfg = load_cfg(os.path.join(ROOT, "configs", "shape", "proc", "sphere_enc.yaml"))
    keys = ("sdf_freq", "use_fused_sdf", "shader_config")
    assert {k: yaml_cfg[k] for k in keys} == {
        "sdf_freq": 8, "use_fused_sdf": True,
        "shader_config": {"ide_deg": 4, "light_pos_freq": 10}}
    return {**PARITY_CFG, **{k: yaml_cfg[k] for k in keys}}


# Gradient bars: each leaf's difference from nero_tpu's in L2, over the
# larger of its own L2 norm and 1e-2 of the step's largest gradient entry per
# element (tests/test_torch_shape_e2e.py's floor). With the SDF's PE at 8
# octaves the top octave is 2^7 x (the shipped 6's: 2^5 x) and with the
# light points' PE at 10 it is 2^9 x (the shipped: 2^7 x): they amplify the
# packages' last-bit differences in the sample points, most in the
# occlusion head, whose loss turns on marched hits. Measured on these steps
# (worst leaf; the losses equal to 7e-7): before the occlusion phase 3.6e-4
# with both, 3.6e-5 with the shader's encodings alone; in it 4.4e-3 and
# 3.4e-4 (the occlusion head's biases). The largest single entries there
# differ by up to 7e-2 and 7e-3 of their leaf's max: a few rows.
STAGE1_BARS = {"enc": 1e-2, "shader_only": 1e-3}


@pytest.mark.parametrize("step", [3, 6], ids=["before_occ", "occ_phase"])
@pytest.mark.parametrize("which", list(STAGE1_BARS))
def test_stage1_enc_loss_and_grads_match_jax(which, step):
    """A Stage-I step of the sphere_enc network (64 + 32 samples a ray cut to
    16 + 8; `shader_only`: with the shipped SDF) before and inside the
    occlusion phase: the loss within 1e-4 and every gradient leaf within
    STAGE1_BARS of nero_tpu's; the SDF's first layer is 51 wide and the
    shader's heads 38, 101 and 102."""
    cfg = _enc_cfg()
    if which == "shader_only":
        cfg = {k: v for k, v in cfg.items() if k not in ("sdf_freq", "use_fused_sdf")}
    scfg_j = JR.shape_config_from_dict(dict(cfg))
    params_j = jax.tree_util.tree_map(
        np.asarray, JR.init_shape_params(jax.random.PRNGKey(0), scfg_j))
    model = NeROShapeModel(dict(cfg), training=True, device="cpu")
    assert model.scfg.sdf_freq == (8 if which == "enc" else 6)
    assert (model.scfg.shader.ide_deg, model.scfg.shader.light_pos_freq) == (4, 10)
    assert params_j["sdf"][0]["v"].shape[0] == 3 + 6 * model.scfg.sdf_freq
    assert params_j["shader"]["inner_light"][0]["v"].shape[0] == 101
    rays = _parity_rays(model)
    j = {k: jnp.asarray(v) for k, v in rays.items()}

    def loss_j(p):
        out = JR.render(p, scfg_j, jnp.asarray(jax_fg_lut()), j["rays_o"], j["rays_d"],
                        j["near"], j["far"], j["human_poses"], step, key=jax.random.PRNGKey(0),
                        is_train=True, perturb_overwrite=0.0)
        out["loss_rgb"] = JR.compute_rgb_loss(out["ray_rgb"], j["rgb"], "charbonier")
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
    floor = 1e-2 * max(np.abs(a).max() for _, a in grads_j)
    got = dict(tree_items(model.params))
    assert set(got) == {k for k, _ in grads_j}
    for k, a in grads_j:
        b = got[k].grad
        b = np.zeros_like(a) if b is None else b.numpy()
        err = np.linalg.norm(b - a) / max(np.linalg.norm(a), floor * np.sqrt(a.size))
        assert err <= STAGE1_BARS[which], (k, err)


def test_stage2_enc_two_steps_match_jax(monkeypatch):
    """Two Stage-II steps of bowl_enc's shading (both light heads on the
    full lattice, `direction` outer light, IDE degree 4, fused_lights on)
    on the analytic sphere occluder: the port resolves the light kernel
    (its wrapper, plain on the CPU, evaluates both heads in mode `both`),
    nero_tpu off its TPU its XLA path; each step's loss within 1e-5 and
    every gradient as tests/test_torch_mc_shading.py holds them, then an
    SGD update of both from their own gradients."""
    yaml_cfg = load_cfg(os.path.join(ROOT, "configs", "material", "proc", "bowl_enc.yaml"))
    sh = yaml_cfg["shader_cfg"]
    assert (sh["ide_deg"], sh["fused_lights"], sh["outer_light_version"]) == (4, True, "direction")
    keys = ("outer_light_version", "fused_lights", "ide_deg", "light_exp_max",
            "inner_light_exp_max")
    cfg_j, cfg_t = _cfgs(**{k: sh[k] for k in keys})
    assert T.fused_lights_active(cfg_t)
    pj = jax.tree_util.tree_map(np.asarray, J.init_mc_shading(jax.random.PRNGKey(1), cfg_j))
    pt = from_numpy_tree(pj)
    pj = jax.tree_util.tree_map(jnp.asarray, pj)
    pts, view, normals, _ = _points(1)
    sj, st = J.make_direction_samples(cfg_j), T.make_direction_samples(cfg_t)
    modes = []
    real = T.lights_raw
    monkeypatch.setattr(T, "lights_raw", lambda *a, **k: (modes.append(k.get("mode", a[-1])),
                                                          real(*a, **k))[1])

    def loss_j(p):
        colors, _ = J.mc_shading_apply(p, cfg_j, sj, trace_j, jnp.asarray(pts),
                                       jnp.asarray(view), jnp.asarray(normals), None)
        return jnp.mean((colors - 0.5) ** 2)

    lr = 0.1
    for step in range(2):
        lj, g_j = jax.value_and_grad(loss_j)(pj)
        colors_t, _ = T.mc_shading_apply(pt, cfg_t, st, trace_t, torch.from_numpy(pts),
                                         torch.from_numpy(view), torch.from_numpy(normals), None)
        lt = torch.mean((colors_t - 0.5) ** 2)
        assert float(lt.detach()) == pytest.approx(float(lj), rel=1e-5), step
        g_t = _torch_grads(lt, pt)
        _grad_close(g_t, g_j, f"step {step}")
        pj = jax.tree_util.tree_map(lambda a, g: a - lr * g, pj, g_j)
        pt = from_numpy_tree({k: v for k, v in jax.tree_util.tree_map(np.asarray, pj).items()})
    assert modes == ["both", "both"]
