"""The whole-shader kernel (B2) at light_pos_freq past one 256-wide tile on
the CPU: nero_tpu's kernel pads each head's input to a multiple of 128 and
takes any light_pos_freq; the port's takes 0-128 (ops/shader.py::
MAX_LIGHT_PE). Its plain twin and the emulation of its rounding points
against nero_tpu's `shader_fused_raw` in interpret mode at degree 5 and
light_pos_freq 20, 31, 32 and 64 (default variant) and 32 (`human_light`), with
the light points' PE rows drawn at 0.01 / 2^i
(torch_encoding_shader_common.scale_pe_rows); the gate against nero_tpu's
rule; csrc/shader.cu's shared memory, slab stream and windows at every
width it takes; the launch counters and FLOP tallies past 256 columns; one
Stage-I step of configs/shape/proc/sphere_lpf32.yaml against nero_tpu. The
CUDA kernel itself is held against the plain version at these widths on the
card by chip_smoke.py's phase 11."""
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nero_tpu.fields.app_shading import AppShadingConfig as JShCfg, fused_shader_supported
from nero_tpu.ops.fg_lut import get_fg_lut as jax_fg_lut
from nero_tpu.render import shape as JR
from nero_tpu.train.losses import compute_losses as jax_compute_losses, total_loss as jax_total
from nero_tpu_torch.core import mfu
from nero_tpu_torch.core.config import load_cfg
from nero_tpu_torch.core.convert import from_numpy_tree, tree_items
from nero_tpu_torch.fields.app_shading import AppShadingConfig, fused_shader_active
from nero_tpu_torch.models.shape import NeROShapeModel
from nero_tpu_torch.ops import shader as Sh
from nero_tpu_torch.utils.encodings import ide_dim
from test_torch_shape_e2e import PARITY_CFG, ROOT, _parity_rays
from torch_csrc import source_constants
from torch_encoding_shader_common import check_forward, check_grads, scale_pe_rows

torch.set_num_threads(1)

SMEM_MAX = 232448  # a block's shared memory on the H100


@pytest.mark.parametrize("variant,lpf", [("default", 20), ("default", 31), ("default", 32),
                                         ("default", 64), ("human", 32)])
def test_forward_against_pallas(variant, lpf):
    """torch_encoding_shader_common.check_forward's bars at degree 5: the
    heads to 3e-2 (plain) and 2e-3 (emulated), reflective and NoV to 1e-5,
    colour and occ_prob of the emulation within 2e-3 of the plain one's."""
    check_forward(variant, 5, lpf, scaled_pe=True)


def test_grads_against_pallas():
    """check_grads' bars at (5, 32): the inner light head's input is 267
    columns (272 padded), the occ head's 234."""
    check_grads("default", 5, 32, scaled_pe=True)


def test_supported_is_nero_tpus_rule():
    """feats_dim {128, 256} x ide_deg 1-6 x light_pos_freq 0-64: the kernel
    takes a configuration exactly where nero_tpu's fused_shader_supported
    does; past MAX_LIGHT_PE (octave 127: 2^i is the last finite f32 power of
    two) the per-head path."""
    for feats in (128, 256):
        for deg in range(1, 7):
            for lpf in range(0, 65):
                nero = fused_shader_supported(JShCfg(ide_deg=deg, feats_dim=feats,
                                                     light_pos_freq=lpf))
                cfg = AppShadingConfig(ide_deg=deg, feats_dim=feats, light_pos_freq=lpf)
                assert Sh.supported(cfg) == nero, (feats, deg, lpf)
    assert Sh.MAX_LIGHT_PE == 128 and float(np.float32(2.0 ** 127)) < np.inf
    assert Sh.supported(AppShadingConfig(light_pos_freq=128))
    assert not Sh.supported(AppShadingConfig(light_pos_freq=129))


def test_fused_shader_active_past_one_tile():
    """light_pos_freq 32 takes the kernel under fused_shader null and true
    with no warning; past MAX_LIGHT_PE true warns and takes the per-head
    path."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for fs in (None, True):
            assert fused_shader_active(AppShadingConfig(light_pos_freq=32, fused_shader=fs))
        assert not fused_shader_active(AppShadingConfig(light_pos_freq=32, fused_shader=False))
    with pytest.warns(RuntimeWarning):
        assert not fused_shader_active(AppShadingConfig(light_pos_freq=129, fused_shader=True))


# ---------------------------------------------------------------------------
# csrc/shader.cu's layout at every width it takes
# ---------------------------------------------------------------------------

_NAMES = ("PB", "LDA", "LDP", "SLAB_K", "LDB", "LDT", "STAGES", "RSB", "TAB", "TILE_ELEMS",
          "DX_MAX", "DX_STAGE", "DXP", "DI_LIGHT", "DI_OUTER", "DI_OUTER_SPH", "DI_INNER",
          "DI_OCC", "NIDE", "HID")
_EVALS = ("metallic", "roughness", "albedo", "outer_light", "outer_light", "inner_light",
          "inner_weight")


def _slabs(cfg, c) -> int:
    """The stream of csrc/shader.cu's slab_at: the forward's W1-W4 of every
    evaluation, then the sweep's W4^T, W3^T, W2^T and the W1^T of every
    evaluation that wants dX (dx_pieces: the inner head's in DXP-row pieces
    where a light input outgrows the tile)."""
    pads, k, hs = Sh.head_pad(cfg), c["SLAB_K"], 256 // c["SLAB_K"]
    evals = _EVALS + (("human_light",) if cfg.human_light else ())
    wide = c["DI_LIGHT"] > c["HID"]
    fwd = sum(-(-pads[h] // k) + 3 * hs for h in evals)
    pieces = {"inner_weight": 0, "inner_light": -(-pads["inner_light"] // c["DXP"]) if wide else 1}
    return fwd + sum(1 + (2 + pieces.get(h, 1)) * hs for h in evals)


def test_shader_layout_at_every_light_pe():
    """At every (ide_deg 1-5, light_pos_freq 0-128) in the four variants:
    the head widths ops/shader.py pads to; up to one 256-wide tile of light
    input the parent's layout (an input cotangent over 144 columns grows the
    tile region and takes 64-row slabs); past it (WIDE: degree 5 from
    light_pos_freq 31 on) 128-row slabs, the activation and points tiles
    alone, which hold a 128-column f32 piece of dX and the outer head's whole
    dX; the slab table's offsets within 32 bits and both kernels' shared
    memory within a block's 232,448 bytes."""
    wide_from = {}
    for deg in range(1, 6):
        for lpf in range(0, 129):
            c = source_constants(("encode.cuh", "shader.cu"), _NAMES,
                                 {"NERO_IDE_DEG": deg, "NERO_LIGHT_PE": lpf})
            assert c["NIDE"] == ide_dim(deg)
            wide = c["DI_LIGHT"] > 256
            if wide:
                wide_from.setdefault(deg, lpf)
            tiles = c["PB"] * (c["LDA"] + c["LDP"])
            if wide:
                assert c["DX_STAGE"] == max(c["DXP"], c["DI_OUTER_SPH"]) <= 144
                assert c["SLAB_K"] == 128 and c["TILE_ELEMS"] == tiles
            else:
                assert c["DX_STAGE"] == c["DX_MAX"] <= 256
                assert (c["SLAB_K"] == 64) == (c["PB"] * c["DX_MAX"] * 2 > tiles)
            assert c["TILE_ELEMS"] * 2 >= c["PB"] * c["DX_STAGE"] * 4
            stage = max(c["SLAB_K"] * c["LDB"], 256 * c["LDT"])
            for sphere in (False, True):
                for human in (False, True):
                    cfg = AppShadingConfig(sphere_direction=sphere, human_light=human,
                                           ide_deg=deg, light_pos_freq=lpf)
                    pads = Sh.head_pad(cfg)
                    assert pads["outer_light"] == (c["DI_OUTER_SPH"] if sphere else c["DI_OUTER"])
                    assert (pads["inner_light"], pads["inner_weight"]) == (c["DI_INNER"],
                                                                           c["DI_OCC"])
                    assert max(pads["inner_light"], pads["inner_weight"]) == c["DI_LIGHT"]
                    smem = ((c["TILE_ELEMS"] + c["STAGES"] * stage) * 2 + c["PB"] * c["RSB"] * 4
                            + c["TAB"] * 4 + _slabs(cfg, c) * 12)
                    assert smem <= SMEM_MAX, (deg, lpf, sphere, human, smem)
                    heads = Sh.head_order(cfg)
                    assert Sh.weight_elems([pads[h] for h in heads]) < 2 ** 32
    # degree 5: the inner head's 3 + 6 * 31 + 72 = 261 columns; below it the
    # occ head's 3 + 6 * 36 + 39 = 258 first
    assert wide_from == {5: 31, 4: 36, 3: 36, 2: 36, 1: 36}


def test_wide_windows_in_the_source():
    """The paths of a light input past one tile: the forward and the
    recompute build it in 256-column windows (the recompute storing each to
    the scratch), the sweep takes the inner head's dX in DXP-column pieces
    with GZ1 reloaded from the scratch, and every octave's frequency is the
    exact f32 2^i (pow2f: an int shift overflows at octave 31)."""
    with open(os.path.join(os.path.dirname(Sh.__file__), "..", "csrc", "shader.cu")) as f:
        src = f.read()
    with open(os.path.join(os.path.dirname(Sh.__file__), "..", "csrc", "encode.cuh")) as f:
        enc = f.read()
    assert src.count("build_window<L>(slot, c0, A, rs,") == 2
    assert src.count("store_window(A, S.x(slot), di, c0,") == 1
    assert "enc_bwd_piece<L>(D, c0, w, rs, tab);" in src
    assert "if (c0 > 0) load_tile(A, S.gz(5, 0), row0);" in src
    assert "1 << i" not in src and "1 << i" not in enc
    assert "__int_as_float((127 + i) << 23)" in enc
    # pow2f's exponent bits are 2^i for every octave the kernel takes
    for i in range(Sh.MAX_LIGHT_PE):
        assert np.array([(127 + i) << 23], np.int32).view(np.float32)[0] == np.float32(2.0 ** i)


# ---------------------------------------------------------------------------
# launch counters, FLOP tallies, MFU
# ---------------------------------------------------------------------------


class _FakeLib:
    """A shader library that launches nothing: the C entries return 0, the
    size queries answer for the widths of `cfg`."""

    def __init__(self, welems):
        self.welems = welems

    def __getattr__(self, name):
        return lambda *a: self.welems if name == "shader_weight_elems" else (
            64 if "elems" in name else 0)


@pytest.mark.parametrize("sphere,human", [(0, 0), (1, 1)])
def test_counters_and_flops_past_one_tile(monkeypatch, sphere, human):
    """A launch at (5, 32) counts under `shader_{fwd,bwd}[_scenes]<variant>
    _d5p32` with flops(...) at those widths: the inner head's 267 input
    columns and the occ head's 234; count_flops and expect_kernels see
    them."""
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("Stream", (), {"cuda_stream": 0})())
    monkeypatch.setattr(Sh, "launches", dict(Sh.launches))
    monkeypatch.setattr(Sh, "flop_tally", dict(Sh.flop_tally))
    cfg = AppShadingConfig(sphere_direction=bool(sphere), human_light=bool(human),
                           light_pos_freq=32)
    pads = Sh.head_pad(cfg)
    assert (pads["inner_light"], pads["inner_weight"]) == (272, 240)
    welems = Sh.weight_elems([pads[h] for h in Sh.head_order(cfg)])
    monkeypatch.setattr(Sh, "_lib", lambda enc=(5, 8): _FakeLib(welems))
    n = 96
    geo, feats, W = torch.zeros(n, Sh.geo_width(cfg)), torch.zeros(n, 256), torch.zeros(welems)
    B = torch.zeros(7, 4, 256)

    def step():
        Sh._fwd(geo, feats, W, B, sphere, human, (5, 32))
        Sh._bwd(geo, feats, W, B, sphere, human, torch.zeros(n, 24), (5, 32))
        Sh._fwd(geo.view(2, n // 2, -1), feats.view(2, n // 2, -1), W.expand(2, -1), B,
                sphere, human, (5, 32))

    _, counted = mfu.count_flops(step)
    sfx = Sh.variant(cfg)
    assert sfx.endswith("_d5p32")
    for name, k, flop in (("shader_fwd", 1, Sh.flops(n, cfg)),
                          ("shader_bwd", 1, Sh.flops(n, cfg, backward=True)),
                          ("shader_fwd_scenes", 1, Sh.flops(n, cfg))):
        assert Sh.launches[name + sfx] == k and Sh.flop_tally[name + sfx] == flop
        assert counted["kernels_by_name"][name + sfx] == flop
        assert counted["launches_by_name"][name + sfx] == k
    assert counted["unknown"] == 0
    mfu.expect_kernels({"shader_fwd": True, "shader_fwd" + sfx: True, "shader_bwd" + sfx: True},
                       launches=counted["launches_by_name"])
    # the products at the true widths: the light PE's 6 x 24 more columns
    # in both light heads' first layers, beside (5, 8)
    base = Sh.variant_cfg(sphere, human)
    assert Sh.flops_per_row(cfg) - Sh.flops_per_row(base) == 2 * 2 * 144 * 256
    assert Sh.flops(n, cfg, backward=True) == 3 * Sh.flops(n, cfg)


# ---------------------------------------------------------------------------
# one Stage-I step of sphere_lpf32.yaml against nero_tpu
# ---------------------------------------------------------------------------

# Gradient bars: each leaf's difference from nero_tpu's in L2 over the larger
# of its own L2 norm and 1e-2 of the step's largest gradient entry per
# element (tests/test_torch_encoding_widths_e2e.py's measure). The two
# packages' sample points differ in their last bits, which octave i of the
# light points' PE multiplies by 2^i: past octave LIVE_OCTAVES the sin and
# cos columns of the two packages are unrelated numbers of the same size, and
# so are the gradients of their first-layer rows (held here to be finite and
# of the same size, within a factor of 2 in L2); their forward contribution is
# small, the rows being drawn at 0.01 / 2^i. Measured on these steps (worst
# leaf; losses within 1e-6): before the occlusion phase 2.7e-5, in it 2.3e-3
# (the occlusion head's biases, whose loss turns on marched hits; 3.4e-4 at
# light_pos_freq 10 in that file).
LPF32_BARS = {3: 1e-3, 6: 5e-3}
LIVE_OCTAVES = 12


def _lpf32_cfg() -> dict:
    yaml_cfg = load_cfg(os.path.join(ROOT, "configs", "shape", "proc", "sphere_lpf32.yaml"))
    base = load_cfg(os.path.join(ROOT, "configs", "shape", "proc", "sphere.yaml"))
    assert {k: v for k, v in yaml_cfg.items() if k not in ("name", "shader_config")} == {
        k: v for k, v in base.items() if k != "name"}
    assert yaml_cfg["shader_config"] == {"light_pos_freq": 32}
    return {**PARITY_CFG, "shader_config": yaml_cfg["shader_config"]}


@pytest.mark.parametrize("step", [3, 6], ids=["before_occ", "occ_phase"])
def test_stage1_lpf32_step_matches_jax(step):
    """A Stage-I step of the sphere_lpf32 network at the parity test's sizes
    (f32 both sides) before and inside the occlusion phase: the loss within
    1e-4 relative and every gradient leaf within LPF32_BARS of nero_tpu's,
    the light PE's rows past LIVE_OCTAVES as stated above."""
    cfg = _lpf32_cfg()
    scfg_j = JR.shape_config_from_dict(dict(cfg))
    params_j = jax.tree_util.tree_map(np.asarray,
                                      JR.init_shape_params(jax.random.PRNGKey(0), scfg_j))
    params_j["shader"] = scale_pe_rows(params_j["shader"], 32, np.random.default_rng(32))
    model = NeROShapeModel(dict(cfg), training=True, device="cpu")
    assert model.scfg.shader.light_pos_freq == 32 and fused_shader_active(model.scfg.shader)
    assert params_j["shader"]["inner_light"][0]["v"].shape[0] == 3 + 6 * 32 + 72
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
    dead = slice(3 + 6 * LIVE_OCTAVES, 3 + 6 * 32)
    errs = {}
    for k, a in grads_j:
        b = got[k].grad
        b = np.zeros_like(a) if b is None else b.numpy()
        if k.split("|")[-1] == "v" and ("inner_light" in k or "inner_weight" in k) and \
                k.split("|")[-2] == "0":
            a_dead, b_dead = a[dead], b[dead]
            assert np.isfinite(b_dead).all()
            ratio = np.linalg.norm(b_dead) / max(np.linalg.norm(a_dead), 1e-30)
            assert 0.5 < ratio < 2.0, (k, ratio)
            a, b = np.delete(a, np.r_[dead], 0), np.delete(b, np.r_[dead], 0)
        errs[k] = np.linalg.norm(b - a) / max(np.linalg.norm(a), floor * np.sqrt(a.size))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= LPF32_BARS[step], (worst, errs[worst])
