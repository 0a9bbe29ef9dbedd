"""The whole-shader kernel's forward (csrc/shader.cu::shader_fwd_kernel) as
far as the CPU can hold it, in all four variants: its rounding points (bf16
inputs X and activations H, f32 sums, f32 biases, kappa from the f32
roughness z) emulated in plain torch against nero_tpu's TPU kernel
`shader_fused_raw` in interpret mode, column by column, and against
nero_tpu's XLA shader at chip_smoke.py's bars; a mirror of the forward's
shared memory against the constants of the source; the zero-row case of the
wrapper. The kernel itself is held against its plain version and this
emulation on the card by the `gpu`-marked test and by chip_smoke.py."""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nero_tpu.fields.app_shading import AppShadingConfig as JCfg, app_shading_apply as jax_apply
from nero_tpu.ops.fg_lut import get_fg_lut as jax_fg_lut
from nero_tpu.ops.pallas.shader_kernel import shader_fused_raw
from nero_tpu_torch.core.convert import from_numpy_tree
from nero_tpu_torch.fields.app_shading import AppShadingConfig, shade_from_raw
from nero_tpu_torch.ops import cuda_build, shader
from nero_tpu_torch.ops.fg_lut import get_fg_lut
from nero_tpu_torch.ops.mlp import resolve_weight_norm
from torch_csrc import source_constants
from torch_shader_common import VARIANTS, _kernel_head, _setup

torch.set_num_threads(1)

GEOMETRY = ("reflective", "NoV")


def _emulated_raw(cfg, p, pts, normals, view, feats, hp):
    """The packed raw [..., 24] with the forward's rounding points: every
    head on the resolved weights through `_kernel_head`."""
    with torch.no_grad():
        return shader.shader_raw_plain(resolve_weight_norm(p), cfg, pts, normals, view, feats,
                                       hp if cfg.human_light else None, head=_kernel_head)


def _compare_raw(got: dict, want: dict, human: bool) -> dict:
    """Column by column: the heads to 2e-3, reflective and NoV to 1e-5, the
    human hit mask as a rate (>= 0.9999; it is a threshold on f32 values)."""
    assert set(got) == set(want)
    err = {}
    for k, v in want.items():
        a, b = np.asarray(got[k]), np.asarray(v)
        assert a.shape == b.shape, k
        if k == "human_hits":
            same = float((a == b).mean())
            assert same >= 0.9999, (k, same)
            assert 0.02 < float(b.mean()) < 0.98, "no hit and miss rows: the check is vacuous"
            continue
        err[k] = float(np.abs(a - b).max())
        assert err[k] <= (1e-5 if k in GEOMETRY else 2e-3), (k, err[k])
    assert ("human_z" in err) == human
    return err


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_rounding_points_hold_the_bar(variant):
    """The emulated kernel forward against the TPU kernel (interpret mode)
    column by column, and its colour, occ_prob (2e-3) and reflective (1e-5)
    against the XLA shader in f32."""
    kw, params_j, inputs, _ = _setup(variant)
    cfg = AppShadingConfig(**kw)
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    raw = _emulated_raw(cfg, from_numpy_tree(params_j), t["pts"], t["normals"], t["view"],
                        t["feats"], t["hp"])
    assert raw.shape == inputs["pts"].shape[:-1] + (shader.OUT,)
    args = [jnp.asarray(inputs[k]) for k in ("pts", "normals", "view", "feats")]
    raw_j = shader_fused_raw(params_j, JCfg(**kw), *args, human_poses=jnp.asarray(inputs["hp"]),
                             interpret=True)
    err = _compare_raw(shader.unpack_raw(raw, cfg.human_light), raw_j, cfg.human_light)
    # the emulation is no copy of the f32 plain version: bf16 moves the heads
    with torch.no_grad():
        plain = shader.shader_raw_plain(from_numpy_tree(params_j), cfg, t["pts"], t["normals"],
                                        t["view"], t["feats"], t["hp"])
    assert float((raw[..., :15] - plain[..., :15]).abs().max()) > 1e-5
    assert max(err[k] for k in err if k not in GEOMETRY) > 0.0
    lut = jnp.asarray(jax_fg_lut())
    c_j, o_j = jax_apply(params_j, JCfg(fused_shader=False, **kw), lut, *args,
                         jnp.asarray(inputs["hp"]))
    c_t, o_t = shade_from_raw(raw, cfg, torch.from_numpy(get_fg_lut()))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=2e-3)
    np.testing.assert_allclose(o_t["occ_prob"].numpy(), np.asarray(o_j["occ_prob"]), atol=2e-3)
    np.testing.assert_allclose(o_t["reflective"].numpy(), np.asarray(o_j["reflective"]),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the forward's shared memory: a mirror of csrc/shader.cu's layout
# ---------------------------------------------------------------------------

_NAMES = ("NTHREADS", "HID", "DO", "PB", "LDA", "PTW", "LDP", "SLAB_K", "LDB", "LDT", "STAGES",
          "HS", "RSB", "NML", "LMAX", "TAB", "TILE_ELEMS")
SMEM_MAX = 232448  # a block's shared memory on the H100
SLAB_REC = 12      # SlabRec: unsigned offset, four unsigned shorts


def _source_constants(enc=(5, 8)) -> dict:
    """csrc/shader.cu's constants at the build of (ide_deg, light_pos_freq)."""
    c = source_constants(("encode.cuh", "shader.cu"), _NAMES,
                         {"NERO_IDE_DEG": enc[0], "NERO_LIGHT_PE": enc[1]})
    c["STAGE_ELEMS"] = max(c["SLAB_K"] * c["LDB"], c["HID"] * c["LDT"])
    with open(os.path.join(cuda_build.CSRC, "shader.cu")) as f:
        c["B_HIT"] = int(re.search(r"B_HIT = (\d+)", f.read()).group(1))
    return c


def slab_stream(cfg, c: dict) -> tuple:
    """(the forward's slabs, the sweep's slabs) as (offset, rows, cols) in
    the packed weights, as csrc/shader.cu::slab_at lays them out: W1-W4 of
    every evaluation in order, in slabs of up to SLAB_K rows; then the
    sweep's W4^T, W3^T, W2^T (and W1^T where dX is wanted) of each
    evaluation in its order, in slabs of SLAB_K output columns."""
    heads = shader.head_order(cfg)
    pads = shader.head_pad(cfg)
    hid, do, k = c["HID"], c["DO"], c["SLAB_K"]
    off, start = 0, {}
    for h in heads:
        start[h] = off
        off += shader.weight_elems([pads[h]])
    evals = ["metallic", "roughness", "albedo", "outer_light", "outer_light", "inner_light",
             "inner_weight"] + (["human_light"] if cfg.human_light else [])
    fwd = []
    for h in evals:
        di, w = pads[h], start[h]
        fwd += [(w + r * hid, min(k, di - r), hid) for r in range(0, di, k)]
        for l in range(3):
            nc = do if l == 2 else hid
            w2 = w + di * hid + l * hid * hid
            fwd += [(w2 + r * nc, k, nc) for r in range(0, hid, k)]
    order = ([7] if cfg.human_light else []) + [6, 5, 4, 3, 1, 0, 2]
    sweep = []
    for e in order:
        h = evals[e]
        di, w = pads[h], start[h]
        w2 = w + di * hid
        sweep.append((w2 + 2 * hid * hid, hid, do))
        for l in (2, 1, 0)[:2 if e == 6 else 3]:
            base = w if l == 0 else w2 + (l - 1) * hid * hid
            sweep += [(base + j, min(di, hid) if l == 0 else hid, k) for j in range(0, hid, k)]
    return fwd, fwd + sweep


def smem_bytes(c: dict, n_slabs: int) -> int:
    """Tiles (activations, points; the sweep's f32 dX over them, which at
    the shipped widths fills them exactly), the ring, the row state, the IDE
    table, the slab table."""
    pb = c["PB"]
    assert c["TILE_ELEMS"] >= pb * (c["LDA"] + c["LDP"])
    return ((c["TILE_ELEMS"] + c["STAGES"] * c["STAGE_ELEMS"]) * 2
            + pb * c["RSB"] * 4 + c["TAB"] * 4 + n_slabs * SLAB_REC)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_smem_mirror(variant):
    """The forward's tile, slab table and shared memory: 128-row tiles (the
    wrapper's TILE), 4 lanes a row, the hit mask inside the row state; its
    slab count the recompute prefix of the sweep's stream, which covers every
    weight of every evaluation once; both kernels within 232,448 bytes."""
    cfg = AppShadingConfig(**VARIANTS[variant])
    c = _source_constants()
    assert c["PB"] == shader.TILE == 128
    assert c["NTHREADS"] == 4 * c["PB"]
    assert c["B_HIT"] < c["RSB"]
    fwd, sweep = slab_stream(cfg, c)
    assert sweep[:len(fwd)] == fwd
    pads = shader.head_pad(cfg)
    n_eval = 8 if cfg.human_light else 7
    evals = list(shader.head_order(cfg)) + ["outer_light"]
    assert len(fwd) == sum(-(-pads[h] // 128) + 6 for h in evals)
    assert len(fwd) == {"default": 55, "sphere": 57, "human": 62, "both": 64}[variant]
    # each evaluation's W1-W4 exactly once, in order and without gaps
    elems = sum(r * col for _, r, col in fwd)
    assert elems == sum(shader.weight_elems([pads[h]]) for h in evals)
    assert len(sweep) - len(fwd) == n_eval * 7 - 2
    assert sweep[len(fwd)][1:] == (256, 16)  # the sweep begins with W4^T
    f_bytes, s_bytes = smem_bytes(c, len(fwd)), smem_bytes(c, len(sweep))
    assert f_bytes <= s_bytes <= SMEM_MAX, (f_bytes, s_bytes)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_zero_rows(variant):
    """No rows: a (0, 24) output from the wrapper's launch function, with no
    launch counted, and from `shader_raw`."""
    kw, params_j, _, _ = _setup(variant)
    cfg = AppShadingConfig(**kw)
    p = from_numpy_tree(params_j)
    z3, z256 = torch.zeros(0, 3), torch.zeros(0, 256)
    hp = torch.zeros(0, 3, 4) if cfg.human_light else None
    geo, feats, spec, ws, bs = shader.kernel_inputs(p, cfg, z3, z3, z3, z256, hp)
    W, B = shader.pack_weights(ws, bs, spec[2])
    before = dict(shader.launches)
    out = shader._fwd(geo, feats, W, B, *spec[:2])
    assert out.shape == (0, shader.OUT) and shader.launches == before
    assert shader.shader_raw(p, cfg, z3, z3, z3, z256, hp).shape == (0, shader.OUT)


def test_ptxas_spills_are_the_entrys_own(tmp_path, monkeypatch):
    """ptxas lists the functions an entry calls after it, each with its own
    spill line: chip_smoke.py's 0-spill bars read the entry's line, not the
    last one of its section."""
    sweep = "_ZN12_GLOBAL__N_123shader_bwd_sweep_kernelINS_3VarILb1ELb1EEEEEvPKf"
    callee = "_ZN12_GLOBAL__N_110build_slotINS_3VarILb1ELb1EEEEEviP13__nv_bfloat16"
    fwd = "_ZN12_GLOBAL__N_117shader_fwd_kernelINS_3VarILb1ELb1EEEEEvPKf"
    log = (f"ptxas info    : Compiling entry function '{sweep}' for 'sm_90a'\n"
           f"ptxas info    : Function properties for {sweep}\n"
           "    152 bytes stack frame, 16 bytes spill stores, 24 bytes spill loads\n"
           "ptxas info    : Used 128 registers, used 1 barriers, 152 bytes cumulative stack size\n"
           f"ptxas info    : Function properties for {callee}\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           f"ptxas info    : Compiling entry function '{fwd}' for 'sm_90a'\n"
           f"ptxas info    : Function properties for {fwd}\n"
           "    136 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 123 registers, used 1 barriers, 136 bytes cumulative stack size\n"
           f"ptxas info    : Function properties for {callee}\n"
           "    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n")
    (tmp_path / "lib.so.log").write_text(log)
    monkeypatch.setattr(cuda_build, "_lib_path", lambda name: str(tmp_path / "lib.so"))
    inst = r"\w*Lb1ELb1E"
    assert cuda_build.ptxas_info("shader", "shader_bwd_sweep_kernel" + inst) == {
        "regs": 128, "spill_bytes": 40}
    assert cuda_build.ptxas_info("shader", "shader_fwd_kernel" + inst) == {
        "regs": 123, "spill_bytes": 0}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cuda_forward_matches_emulation(variant):
    """n = 1001 (ragged for the 128-row tile) and 0: the kernel's packed
    outputs against the emulated rounding points column by column (heads
    2e-3, reflective and NoV 1e-5, the hit mask as a rate), its colour and
    occ_prob against the plain version at 2e-3; two calls give the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    kw, params_j, _, _ = _setup(variant)
    cfg = AppShadingConfig(**kw)
    dev = torch.device("cuda")
    p = from_numpy_tree(params_j, device=dev)
    rng = np.random.default_rng(5)
    n = 1001
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    hp = t(np.concatenate([q, rng.uniform(-0.5, 0.5, (n, 3, 1))], -1))
    xs = [t(rng.uniform(-0.6, 0.6, (n, 3))), t(rng.standard_normal((n, 3))),
          t(rng.standard_normal((n, 3))), t(rng.standard_normal((n, 256)) * 0.3)]
    with torch.no_grad():
        geo, feats, spec, ws, bs = shader.kernel_inputs(p, cfg, *xs, hp)
        W, B = shader.pack_weights(ws, bs, spec[2])
        got = shader._fwd(geo, feats, W, B, *spec[:2])
        assert torch.equal(got, shader._fwd(geo, feats, W, B, *spec[:2]))
        plain = shader.shader_raw_plain(p, cfg, *xs, hp if cfg.human_light else None)
    emu = _emulated_raw(cfg, from_numpy_tree(params_j), *[x.cpu() for x in xs], hp.cpu())
    _compare_raw(shader.unpack_raw(got.cpu(), cfg.human_light),
                 shader.unpack_raw(emu, cfg.human_light), cfg.human_light)
    lut = torch.as_tensor(get_fg_lut(), device=dev)
    (c_k, o_k), (c_p, o_p) = shade_from_raw(got, cfg, lut), shade_from_raw(plain, cfg, lut)
    assert (c_k - c_p).abs().max().item() <= 2e-3
    assert (o_k["occ_prob"] - o_p["occ_prob"]).abs().max().item() <= 2e-3
    assert shader._fwd(geo[:0], feats[:0], W, B, *spec[:2]).shape == (0, shader.OUT)
