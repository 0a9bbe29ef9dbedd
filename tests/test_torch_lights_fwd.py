"""The light kernel's forward (csrc/lights.cu::lights_fwd_kernel) as far as
the CPU can hold it, in both modes and both outer-light versions: its
rounding points (bf16 inputs X and activations H, f32 sums, f32 biases;
torch_lights_common.py's `emulate_lights_bwd`, whose values are the
forward's) against nero_tpu's TPU kernel `lights_fused_raw` in interpret
mode and against nero_tpu's unfused XLA light path, column by column, at
chip_smoke.py's bar (values after exp to 3e-3); a mirror of the forward's
weight stream and shared memory against the constants of the source, beside
the sweep's; the zero-row case of the wrapper. The kernel itself is held
against its plain version and this emulation on the card by the
`gpu`-marked test and by chip_smoke.py."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nero_tpu.fields import mc_shading as J
from nero_tpu.ops.mlp import exp_activation as exp_jax
from nero_tpu.ops.pallas.light_kernel import lights_fused_raw
from nero_tpu_torch import kernel_variants
from nero_tpu_torch.core.convert import from_numpy_tree
from nero_tpu_torch.ops import cuda_build
from nero_tpu_torch.ops import lights as L
from nero_tpu_torch.ops.mlp import exp_activation
from torch_lights_common import CASES, _setup, _source_constants, emulate_lights_bwd

torch.set_num_threads(1)

BAR = 3e-3  # after exp: chip_smoke.py's and tests/test_light_kernel.py's


def _emulated(params, cfg_t, inputs, mode):
    """(inner_z, outer_z) with the forward's rounding points, on CPU tensors."""
    with torch.no_grad():
        return emulate_lights_bwd(from_numpy_tree(params), cfg_t,
                                  *map(torch.from_numpy, inputs), mode)


def _activated(cfg_t, inner_z, outer_z) -> np.ndarray:
    """[..., 6]: exp-activated inner_z, outer_z."""
    return torch.cat([exp_activation(inner_z, cfg_t.inner_light_exp_max),
                      exp_activation(outer_z, cfg_t.light_exp_max)], -1).numpy()


def _column_errors(got: np.ndarray, want: np.ndarray) -> list:
    assert got.shape == want.shape
    return [float(np.abs(got[..., k] - want[..., k]).max()) for k in range(got.shape[-1])]


@pytest.mark.parametrize("mode,version", CASES)
def test_forward_rounding_points_hold_the_bar(mode, version):
    """The emulated kernel forward against the TPU kernel (interpret mode)
    and against the unfused XLA light path, each of the six columns within
    3e-3 after exp; mode outer's inner_z exactly zero."""
    cfg_j, cfg_t, params, inputs, _ = _setup(version, p=2, s=48)
    inner_z, outer_z = _emulated(params, cfg_t, inputs, mode)
    got = _activated(cfg_t, inner_z, outer_z)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    args = [jnp.asarray(a) for a in inputs]
    iz_j, oz_j = lights_fused_raw(pj, cfg_j, *args, mode=mode, interpret=True)
    tpu = np.concatenate([np.asarray(exp_jax(iz_j, cfg_j.inner_light_exp_max)),
                          np.asarray(exp_jax(oz_j, cfg_j.light_exp_max))], -1)
    outer_j = np.asarray(J.predict_outer_lights(pj, cfg_j, args[0], args[1]))
    inner_j = (np.asarray(J.get_inner_lights(pj, cfg_j, args[2], -args[1], args[3]))
               if mode == "both" else np.ones_like(outer_j))
    xla = np.concatenate([inner_j, outer_j], -1)
    for ref in (tpu, xla):
        err = _column_errors(got, ref)
        assert max(err) <= BAR, err
    if mode == "outer":
        assert not inner_z.any()
    # the emulation is no copy of the f32 plain version: bf16 moves the heads
    with torch.no_grad():
        plain = L.lights_raw_plain(from_numpy_tree(params), cfg_t,
                                   *map(torch.from_numpy, inputs), mode)
    assert float((torch.cat(plain, -1) - torch.cat([inner_z, outer_z], -1)).abs().max()) > 1e-5


# ---------------------------------------------------------------------------
# the forward's weight stream and shared memory: a mirror of csrc/lights.cu
# ---------------------------------------------------------------------------

SMEM_MAX = 232448  # a block's shared memory on the H100
SLAB_REC = 12      # SlabRec: unsigned offset, four unsigned shorts


def slab_streams(sphere: bool, both: bool, c: dict) -> tuple:
    """(the forward's slabs, the sweep's) as (offset, rows, cols) in the
    packed weights, as csrc/lights.cu::fwd_slab_at and slab_at lay them out:
    the forward W1-W4 of every head in the recompute's order (outer, then
    inner) in slabs of up to SLAB_K rows; the sweep the same without W4,
    then W4^T, W3^T, W2^T and W1^T (its columns dx0 .. dx0 + dxw - 1) of each
    head in slabs of SLAB_K output columns."""
    hid, do, k = c["HID"], c["DO"], c["SLAB_K"]
    names = L.HEAD_ORDER if both else L.HEAD_ORDER[1:]
    di = [c["DI_INNER"] if nm == "inner_light" else c["DI_OUTER_SPH"] if sphere else c["DI_OUTER"]
          for nm in names]
    start = [0, di[0] * hid + 2 * hid * hid + hid * do]
    layer = lambda h, l: start[h] + (0 if l == 0 else di[h] * hid + (l - 1) * hid * hid)
    order = [len(names) - 1] + ([0] if both else [])
    fwd, recompute = [], []
    for h in order:
        w1 = [(start[h] + r * hid, min(k, di[h] - r), hid) for r in range(0, di[h], k)]
        hidden = [(layer(h, l) + r * hid, k, hid) for l in (1, 2) for r in range(0, hid, k)]
        fwd += w1 + hidden + [(layer(h, 3) + r * do, k, do) for r in range(0, hid, k)]
        recompute += w1 + hidden
    sweep = list(recompute)
    for h in order:
        dx0, dxw = (48, 80) if names[h] == "inner_light" else (0, di[h])
        sweep.append((layer(h, 3), hid, do))
        for l in (2, 1, 0):
            sweep += [(start[h] + dx0 * hid + j, dxw, k) if l == 0 else (layer(h, l) + j, hid, k)
                      for j in range(0, hid, k)]
    return fwd, sweep


def smem_bytes(c: dict, sphere: bool, n_slabs: int, sweep: bool) -> int:
    """The tile (the sweep's holds the f32 dX of the widest head too), the
    ring, the row state, the IDE table, the slab table."""
    pb = c["PB"]
    tile = pb * c["LDA"] * 2
    if sweep:
        tile = max(tile, pb * (c["DI_OUTER_SPH"] if sphere else c["DI_OUTER"]) * 4)
    return (tile + c["STAGES"] * c["STAGE_ELEMS"] * 2 + pb * c["RSB"] * 4 + c["TAB"] * 4
            + n_slabs * SLAB_REC)


@pytest.mark.parametrize("sphere,both", [(False, True), (True, False), (True, True),
                                         (False, False)])
def test_forward_smem_mirror(sphere, both):
    """128-row tiles (the wrapper's TILE), 4 lanes a row, 16 warps over 32
    rows x 64 columns each; the forward's slab count, with every weight of
    the evaluated heads, W4 included, streamed exactly once, head by head in
    the recompute's order and each head's layers in order; its shared
    memory at most the sweep's, which is within 232,448 bytes."""
    c = _source_constants()
    assert c["PB"] == L.TILE == 128
    assert c["BTHREADS"] == 4 * c["PB"] and c["BTHREADS"] // 32 == c["PB"] // 32 * c["NQ"]
    fwd, sweep = slab_streams(sphere, both, c)
    outer = 2 if sphere else 1
    assert len(fwd) == outer + 6 + (7 if both else 0)
    assert len(sweep) == len(fwd) - 2 * (2 if both else 1) + (2 if both else 1) * 7
    # each head's slabs contiguous, W1 to W4, its output layer last as two
    # slabs of SLAB_K rows x DO; the outer head first, whose weights follow
    # the inner head's in the packed buffer; together every weight once
    total = L.weight_elems(sphere, both)
    heads = [fwd[:outer + 6], fwd[outer + 6:]] if both else [fwd]
    head_start = [total - L.weight_elems(sphere, False), 0] if both else [0]
    for slabs, first in zip(heads, head_start):
        ends = [o + r * cols for o, r, cols in slabs]
        assert slabs[0][0] == first
        assert [o for o, _, _ in slabs[1:]] == ends[:-1]
        assert [s[1:] for s in slabs[-2:]] == [(c["SLAB_K"], c["DO"])] * 2
    assert sum(r * cols for _, r, cols in fwd) == total
    assert all(r <= c["SLAB_K"] and cols <= c["LDB"] for _, r, cols in fwd)
    # the sweep's recompute has no W4: the forward's stream is not its prefix
    assert sweep[:len(fwd)] != fwd
    f_bytes = smem_bytes(c, sphere, len(fwd), sweep=False)
    s_bytes = smem_bytes(c, sphere, len(sweep), sweep=True)
    assert f_bytes <= s_bytes <= SMEM_MAX, (f_bytes, s_bytes)


@pytest.mark.parametrize("mode", ["both", "outer"])
def test_forward_zero_rows(mode):
    """No rows: a (0, 6) output from the wrapper's launch function, with no
    launch counted, and (0, 3) / (0, 3) from `lights_raw`."""
    _, cfg_t, params, _, _ = _setup("sphere_direction")
    p = from_numpy_tree(params)
    z = torch.zeros(0, 3)
    geo, sphere, both, ws, bs = L.kernel_inputs(p, cfg_t, z, z, z, z, mode)
    W, B = L.pack_buffers(ws, bs, sphere, both)
    before = dict(L.launches)
    assert L._fwd(geo, W, B, sphere, both).shape == (0, L.OUT)
    assert L.launches == before
    inner_z, outer_z = L.lights_raw(p, cfg_t, z, z, z, z, mode)
    assert inner_z.shape == outer_z.shape == (0, 3)


def test_the_forward_runs_on_the_engine():
    """csrc/lights.cu's C entry `lights_fwd` launches `lights_fwd_kernel<L>`
    in all four layouts, and the first-slice rows kernel and its
    common.cuh `block_mm` are gone; `kernel_variants`' `weights_only`
    takes the forward's hidden-layer epilogue with the recompute's."""
    with open(os.path.join(cuda_build.CSRC, "lights.cu")) as f:
        src = f.read()
    assert "lights_rows_kernel" not in src and "block_mm" not in src
    assert "lights_fwd_kernel<L><<<" in src
    assert "LIGHTS_DISPATCH(launch_fwd, sphere, both," in src
    assert src.count(kernel_variants._LI_FWD_EPILOGUE) == 2


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("mode,version", CASES)
def test_cuda_forward_matches_plain_and_emulation(mode, version):
    """n = 1001 (ragged for the 128-row tile) and 0: the kernel's raw
    outputs against the emulated rounding points column by column (2e-3:
    the same rounding points, sums in another order), its values after exp
    against the plain version at 3e-3; two calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    _, cfg_t, params, inputs, _ = _setup(version, p=7, s=143)
    n = 1001
    p = from_numpy_tree(params, device=dev)
    xs = [torch.from_numpy(a).to(dev).reshape(n, 3) for a in inputs]
    with torch.no_grad():
        geo, sphere, both, ws, bs = L.kernel_inputs(p, cfg_t, *xs, mode)
        W, B = L.pack_buffers(ws, bs, sphere, both)
        got = L._fwd(geo, W, B, sphere, both)
        assert torch.equal(got, L._fwd(geo, W, B, sphere, both))
        plain = L.lights_raw_plain(p, cfg_t, *xs, mode)
    emu = torch.cat(_emulated(params, cfg_t, [a.reshape(n, 3) for a in inputs], mode), -1)
    err = _column_errors(got.cpu().numpy(), emu.numpy())
    assert max(err) <= 2e-3, err
    if mode == "outer":
        assert not got[:, 0:3].any()
    err_plain = _column_errors(_activated(cfg_t, got[:, 0:3].cpu(), got[:, 3:6].cpu()),
                               _activated(cfg_t, *(z.cpu() for z in plain)))
    assert max(err_plain) <= BAR, err_plain
    counted = dict(L.launches)
    assert L._fwd(geo[:0], W, B, sphere, both).shape == (0, L.OUT)
    assert L.launches == counted
