"""FLOPs and MFU of the port (core/mfu.py) on the CPU: each kernel's
`flops(...)` against nero_tpu's `hlo_flops` for the same kernel, the
library count of the tiny plain Stage-I step against nero_tpu's XLA count,
the FLOP tallies and `expect_kernels`, the peak table and the trainer's
`mfu`.

nero_tpu counts a kernel's products at its padded TPU widths (inputs and
outputs in lanes of 128, the field's 39 PE channels in 48 sublanes) and, in
the shader and light kernels, also the IDE's Vandermonde products; the port
counts the products the function needs at its true widths (ops/*.py
`flops`). Where the two differ the test states the difference and computes
it."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nero_tpu.core.mfu import flops_breakdown as jax_flops_breakdown
from nero_tpu.fields.app_shading import AppShadingConfig as JShCfg, init_app_shading
from nero_tpu.fields.mc_shading import MCShadingConfig as JMcCfg, init_mc_shading
from nero_tpu.models.shape import NeROShapeModel as JaxShapeModel
from nero_tpu.ops.pallas import (field_kernel as JF, light_kernel as JL, march_kernel as JM,
                                 predictor_kernel as JP, sdf_grad_kernel as JG,
                                 sdf_kernel as JS, shader_kernel as JSh)
from nero_tpu_torch.core import mfu
from nero_tpu_torch.fields.app_shading import AppShadingConfig
from nero_tpu_torch.fields.mc_shading import MCShadingConfig
from nero_tpu_torch.models.shape import NeROShapeModel
from nero_tpu_torch.ops import (field_fwd as F, lights as L, march as M, predictor as P,
                                sdf_fwd as S, sdf_grad as G, shader as Sh, sphere_march as SM)
from nero_tpu_torch.train import trainer as trainer_module
from nero_tpu_torch.train.trainer import Trainer
from test_torch_shape_e2e import TINY_CFG

torch.set_num_threads(1)

N = 4096   # rows: a multiple of every TPU block, so nero_tpu's shapes carry no row padding
H = 256


def _sdf_fwd_formula(n, pe, skip, out):
    """Products of the value-only SDF: w0, w1-w2, w3 (-> skip), w4a, w4b,
    w5-w7, w8, at the given PE, skip and output widths."""
    return 2.0 * n * (pe * H + 2 * H * H + H * skip + skip * H + pe * H + 3 * H * H + H * out)


def test_sdf_fwd_flops():
    """nero_tpu: PE 128, skip 256, output 128 columns; the port: 39, 217, and
    the sdf column alone."""
    assert JS.hlo_flops("nero_sdf_fwd", [(N, 128)], []) == _sdf_fwd_formula(N, 128, H, 128)
    assert S.flops(N) == _sdf_fwd_formula(N, G.N_PE, G.SKIP_W, 1)


def test_sdf_grad_fwd_flops():
    """Four row blocks (the point and three tangents) through every layer.
    nero_tpu: PE 128, skip 256, 384 output columns for all four blocks; the
    port: 39, 217, 257 for the point and the sdf column alone for each
    tangent (grad = d sdf / dx)."""
    block = lambda pe, skip, out: 2 * pe * H + 5 * H * H + 2 * H * skip + H * out
    assert JG.hlo_flops("nero_sdf_grad_fwd", [(N, 8)], []) == 2.0 * 4 * N * block(128, H, 384)
    assert G.flops(N) == 2.0 * N * (4 * block(G.N_PE, G.SKIP_W, 257) - 3 * H * 256)


def test_sdf_grad_bwd_flops():
    """The port counts 0.7803 of nero_tpu's: the forward's padding and
    tangent columns again in the recompute and the weight gradients, and no
    cotangent into the PE (the points carry no gradient)."""
    jax_n = JG.hlo_flops("nero_sdf_grad_bwd", [], [(N, 8)])
    assert G.flops(N, backward=True) / jax_n == pytest.approx(0.78025, abs=1e-5)


@pytest.mark.parametrize("topology", ["std", "wide"])
def test_field_and_march_flops(topology):
    """One field evaluation: nero_tpu's 48 (std; wide 128) input rows and 8
    output rows against the port's 39 (wide 123) and 1. The marches are
    rays x evaluations of it."""
    per = lambda d_in, d_out, hidden: 2 * (d_in * 128 + hidden * 128 * 128 + 128 * d_out)
    wide = topology == "wide"
    jax_eval, port_eval = ((per(128, 8, 1), per(123, 1, 1)) if wide
                           else (per(48, 8, 2), per(39, 1, 2)))
    assert (JF.POINT_FLOPS_WIDE if wide else JF.POINT_FLOPS) == jax_eval
    assert F.flops(N, topology) == N * port_eval
    w = "_w" if wide else ""
    assert JM.hlo_flops(f"nero_march_c32_r8{w}", [(8, N)], []) == N * 40 * jax_eval
    assert M.flops(N, 32, 8, topology) == N * 40 * port_eval
    assert JM.hlo_flops(f"nero_smarch_s18_r2i{w}", [(8, N)], []) == N * 20 * jax_eval
    assert SM.flops(N, 18, 2, topology) == N * 20 * port_eval


@pytest.mark.parametrize("d_in,d_out", P.SHADER_SHAPES)
def test_predictor_flops(d_in, d_out):
    """The same formula: equal at the true widths; nero_tpu's kernel sees
    the input padded to a multiple of 128 and 128 output columns."""
    di, do = JP._pad_dim(d_in), 128
    assert JP.hlo_flops("nero_predictor_fwd", [(N, do)], [(N, di)]) == P.flops(N, di, do)
    assert JP.hlo_flops("nero_predictor_bwd", [], [(N, di), (N, do)]) == \
        P.flops(N, di, do, backward=True)
    assert JP.hlo_flops("nero_predictor_fwd", [(N, d_out)], [(N, d_in)]) == P.flops(N, d_in, d_out)
    assert JP.hlo_flops("nero_predictor_bwd", [], [(N, d_in), (N, d_out)]) == \
        P.flops(N, d_in, d_out, backward=True)
    # without dx the last product of the backward is not needed
    assert P.flops(N, d_in, d_out, True) - P.flops(N, d_in, d_out, True, want_dx=False) == \
        2.0 * N * d_in * H


def _ide_products(deg, n_ide):
    _, l_max, n_ml = JSh._ide_consts_np(deg)
    return n_ide * 2 * (l_max + 1) * n_ml


def _head(d_in, d_out):
    return 2 * (d_in * H + 2 * H * H + H * d_out)


@pytest.mark.parametrize("sphere,human", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_shader_flops(sphere, human):
    """nero_tpu's name bakes in every head once at its padded widths plus
    the IDE products; the port counts the true widths and the outer-light
    head twice (the kernel evaluates it at the reflected and the normal
    direction). The backward is 3x the forward in both."""
    jcfg = JShCfg(sphere_direction=bool(sphere), human_light=bool(human))
    flat = JSh.pack_shader_params(init_app_shading(jax.random.PRNGKey(0), jcfg), jcfg)
    jax_row = JSh._flops_per_row(flat, 5, bool(sphere))
    assert JSh.hlo_flops(f"nero_shader_fwd_f{jax_row}", [(N, 24)], []) == N * jax_row
    dims = Sh.head_dims(AppShadingConfig(sphere_direction=bool(sphere), human_light=bool(human)))
    assert jax_row == sum(_head(JSh._pad_dim(di), 128) for di, _ in dims.values()) + \
        _ide_products(5, 4 if sphere else 2)
    cfg = Sh.variant_cfg(sphere, human)
    assert Sh.flops(N, cfg) == N * sum(_head(di, do) * (2 if h == "outer_light" else 1)
                                       for h, (di, do) in dims.items())
    assert Sh.flops(N, cfg, backward=True) == 3 * Sh.flops(N, cfg)


@pytest.mark.parametrize("sphere,mode", [(0, "both"), (1, "both"), (0, "outer"), (1, "outer")])
def test_light_flops(sphere, mode):
    """Forward: as the shader's, each head once in both. Backward: nero_tpu
    counts 3x its forward; the port counts what the backward needs (no
    output-layer recompute, no dx into the inner head's hit-point PE)."""
    version = "sphere_direction" if sphere else "direction"
    jcfg = JMcCfg(outer_light_version=version)
    params = init_mc_shading(jax.random.PRNGKey(0), jcfg)
    flat = JL.pack_light_params(params, jcfg, mode)
    jax_row = JL._flops_per_row(flat, 5, bool(sphere))
    dims = L.head_dims(MCShadingConfig(outer_light_version=version), mode)
    n_ide = (3 if sphere else 2) if mode == "both" else (2 if sphere else 1)
    assert jax_row == sum(_head(JL._pad_dim(di), 128) for di, _ in dims.values()) + \
        _ide_products(5, n_ide)
    assert JL.hlo_flops(f"nero_lights_fwd_f{jax_row}", [(N, 6)], []) == N * jax_row
    cfg = L.variant_cfg(sphere)
    assert L.flops(N, cfg, mode) == N * sum(_head(di, do) for di, do in dims.values())
    assert L.flops(N, cfg, mode, backward=True) < 3 * L.flops(N, cfg, mode)


def test_library_count_of_the_plain_step_against_xla():
    """The tiny plain Stage-I step (CPU: every kernel is its plain version,
    so all of it is library work). XLA's cost analysis counts elementwise
    work too; PyTorch's counter counts the products: 0.615 of XLA's. The
    forward alone is 0.232, so the bar [0.5, 1.0] refuses a count without
    the backward."""
    cfg = dict(TINY_CFG)
    jm = JaxShapeModel(dict(cfg), training=True)
    opt = optax.adam(1e-3)
    step = jm.make_train_step(opt, donate=False)
    xla = jax_flops_breakdown(step, jm.params, opt.init(jm.params), jax.random.PRNGKey(0),
                              jnp.asarray(0), jm.train_data)["xla"]
    model = NeROShapeModel(dict(cfg), device="cpu")
    b = mfu.flops_breakdown(model.train_step, torch.optim.Adam(model.parameters(), lr=1e-3), 0)
    assert b["kernels"] == 0.0 and b["kernels_by_name"] == {} and b["unknown"] == 0
    assert b["launches_by_name"] == {}
    assert b["total"] == b["library"]
    ratio = b["library"] / xla
    assert 0.5 < ratio < 1.0, ratio


def test_tallies_feed_the_kernel_count(monkeypatch):
    """A launch that adds its flops(...) to its tally counts as kernel work;
    one that adds nothing counts as unknown."""
    for m in (G, Sh):
        monkeypatch.setattr(m, "launches", dict(m.launches))
        monkeypatch.setattr(m, "flop_tally", dict(m.flop_tally))

    def step():
        G.launches["sdf_grad_fwd"] += 1
        G.flop_tally["sdf_grad_fwd"] += G.flops(N)
        Sh.launches["shader_fwd"] += 1
        return torch.ones(4, 4) @ torch.ones(4, 4)

    out, b = mfu.count_flops(step)
    assert out.shape == (4, 4)
    assert b["library"] == 2 * 4 * 4 * 4
    assert b["kernels_by_name"] == {"sdf_grad_fwd": G.flops(N)} and b["unknown"] == 1
    assert b["launches_by_name"] == {"sdf_grad_fwd": 1, "shader_fwd": 1}
    assert b["total"] == b["library"] + G.flops(N)
    assert mfu.launch_counts()["sdf_grad_fwd"] == 1
    assert set(mfu.flop_counts()) >= {"sdf_grad_fwd", "shader_fwd", "sphere_march", "lights_fwd",
                                      "march", "field_fwd", "sdf_fwd"}


def test_expect_kernels_refuses_a_vacuous_configuration():
    launches = {"sdf_grad_fwd": 1, "shader_fwd": 1, "predictor_fwd_72x3": 0}
    assert mfu.expect_kernels({"sdf_grad": True, "predictor": False}, "ok",
                              launches) == ["sdf_grad_fwd", "shader_fwd"]
    with pytest.raises(AssertionError, match="'predictor' launched=False"):
        mfu.expect_kernels({"predictor": True}, "per-head", launches)
    with pytest.raises(AssertionError, match="'shader' launched=True"):
        mfu.expect_kernels({"shader": False}, "no shader", launches)
    # on the CPU nothing launches: every kernel a configuration expects is missing
    with pytest.raises(AssertionError):
        mfu.expect_kernels({"sdf_grad": True}, "cpu")


def test_peak_table(monkeypatch):
    assert mfu.peak_flops_per_sec("cpu") == mfu.CPU_NOMINAL == 1e12
    assert mfu.PEAK_BF16["NVIDIA H100 80GB HBM3"] == 989.4e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    assert mfu.peak_flops_per_sec("cuda:0") == 989.4e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "some other card")
    assert np.isnan(mfu.peak_flops_per_sec("cuda"))
    assert mfu.mfu(989.4e12, 2.0, "cpu") == 989.4 / 2
    assert mfu.mfu(0.0, 1.0, "cpu") == 0.0 and mfu.mfu(1.0, 0.0, "cpu") == 0.0


def test_trainer_logs_mfu(tmp_path):
    """The first step is counted and left out of the meter; every
    train_log_step the log holds mfu > 0 (CPU: against the nominal peak)."""
    cfg = {**TINY_CFG, "val_metric": ["shape_render"], "total_step": 4, "train_log_step": 2,
           "val_interval": 100, "save_interval": 100, "model_root": str(tmp_path),
           "vis_dir": str(tmp_path), "lr_cfg": {"end_warm": 1, "lr": 1e-3}}
    trainer = Trainer(cfg, device="cpu")
    trainer.run()
    assert trainer.flops["library"] > 0 and trainer.flops["total"] == trainer.flops["library"]
    assert [h["step"] for h in trainer.train_history] == [1, 3]
    for h in trainer.train_history:
        assert h["mfu"] == pytest.approx(trainer.flops["total"] / h["step_seconds"] / 1e12)
        assert h["mfu"] > 0
    text = (tmp_path / "test_tiny" / "train.txt").read_text()
    assert text.count(" mfu ") == 2


def test_trainer_counts_the_occlusion_phase_again(tmp_path, monkeypatch):
    """A run that starts before occ_loss_step counts the step again at it: the
    logs before and from it carry the FLOPs of their own phase."""
    cfg = {**TINY_CFG, "val_metric": ["shape_render"], "total_step": 8, "train_log_step": 2,
           "val_interval": 100, "save_interval": 100, "model_root": str(tmp_path),
           "vis_dir": str(tmp_path), "lr_cfg": {"end_warm": 1, "lr": 1e-3}}
    assert cfg["occ_loss_step"] == 5
    trainer = Trainer(cfg, device="cpu")
    counted = []
    real = mfu.count_flops

    def count(fn, step):
        out = real(fn, step)
        counted.append((step, out[1]["total"]))
        return out

    monkeypatch.setattr(trainer_module, "count_flops", count)
    trainer.run()
    assert [s for s, _ in counted] == [0, 5]
    early, occ = counted[0][1], counted[1][1]
    assert occ > early > 0   # the occlusion march's products
    by_step = {h["step"]: h["mfu"] * h["step_seconds"] * 1e12 for h in trainer.train_history}
    assert sorted(by_step) == [1, 3, 5, 7]
    assert by_step[1] == pytest.approx(early) and by_step[3] == pytest.approx(early)
    assert by_step[5] == pytest.approx(occ) and by_step[7] == pytest.approx(occ)

