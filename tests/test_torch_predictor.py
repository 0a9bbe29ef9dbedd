"""The predictor head of the port (ops/predictor.py, its plain version: the
CUDA kernel runs on the card only) against nero_tpu's `apply_predictor` body
in f32 and against the TPU kernel `predictor_fused` in interpret mode at the
bars of tests/test_predictor_kernel.py, values and gradients to x and to
the {v, g, b} leaves; a mirror of the kernel's forward (its weight stream
and shared memory) against the constants of csrc/predictor.cu and
csrc/engine.cuh, and the sources' shape: the forward on the engine, no
`block_mm` left."""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nero_tpu.ops.mlp import apply_predictor as apply_jax, hidden_dtype, init_predictor
from nero_tpu.ops.pallas.predictor_kernel import predictor_fused
from nero_tpu_torch.core.convert import from_numpy_tree, tree_items
from nero_tpu_torch.ops import cuda_build
from nero_tpu_torch.ops import predictor as K
from nero_tpu_torch.ops.mlp import apply_predictor, resolve_weight_norm
from torch_shader_common import _kernel_head

torch.set_num_threads(1)

# tests/test_predictor_kernel.py's shapes, then the Stage-I shader's own
HEAD_SHAPES = [(259, 3), (72, 3), (123, 3), (90, 1), (259, 1), (144, 3), (24, 4)]
N = 300


def _setup(d_in, d_out, shape=(N,)):
    layers = jax.tree_util.tree_map(np.asarray,
                                    init_predictor(jax.random.PRNGKey(d_in), d_in, d_out))
    rng = np.random.default_rng(d_in + d_out)
    x = (rng.standard_normal(shape + (d_in,)) * 0.5).astype(np.float32)
    cot = rng.standard_normal(shape + (d_out,)).astype(np.float32)
    return layers, x, cot


@pytest.mark.parametrize("d_in,d_out", HEAD_SHAPES)
def test_forward(d_in, d_out):
    layers, x, _ = _setup(d_in, d_out)
    ref = np.asarray(apply_jax(layers, jnp.asarray(x), activation="none"))
    with torch.no_grad():
        out = K.predictor(from_numpy_tree(layers), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-4)   # f32 both sides
    fused = np.asarray(predictor_fused(layers, jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(out, fused, atol=2e-3, rtol=1e-2)  # the TPU kernel's bar


@pytest.mark.parametrize("activation,exp_max", [("sigmoid", 0.0), ("exp", 0.0), ("exp", 5.0),
                                                ("none", 0.0)])
def test_apply_predictor_fused_switch(activation, exp_max):
    """`fused=True` on a CPU tensor is the plain version behind the same
    activation: equal to `fused=False` and to nero_tpu."""
    layers, x, _ = _setup(72, 3)
    ref = np.asarray(apply_jax(layers, jnp.asarray(x), activation=activation, exp_max=exp_max))
    p = from_numpy_tree(layers)
    with torch.no_grad():
        a = apply_predictor(p, torch.from_numpy(x), activation, exp_max, fused=True)
        b = apply_predictor(p, torch.from_numpy(x), activation, exp_max, fused=False)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    np.testing.assert_allclose(a.numpy(), ref, atol=1e-5, rtol=1e-4)


def _port_grads(layers, x, cot):
    p = from_numpy_tree(layers)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = (K.predictor(p, xt) * torch.from_numpy(cot)).sum()
    leaves = [v for _, v in tree_items(p)] + [xt]
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _jax_grads(kind, layers, x, cot):
    def loss(p, xx):
        if kind == "fused":
            return jnp.sum(predictor_fused(p, xx, interpret=True) * cot)
        if kind == "bf16":
            with hidden_dtype(jnp.bfloat16):
                return jnp.sum(apply_jax(p, xx, activation="none") * cot)
        return jnp.sum(apply_jax(p, xx, activation="none") * cot)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(layers, jnp.asarray(x))
    gp = jax.tree_util.tree_map(np.asarray, gp)
    return [a for _, a in tree_items(gp)] + [np.asarray(gx)]


@pytest.mark.parametrize("d_in,d_out", [(259, 3), (144, 3), (24, 4), (90, 1)])
def test_grads_match_xla_f32(d_in, d_out):
    """Every {v, g, b} leaf and x: normalised max error < 1e-4 (f32)."""
    layers, x, cot = _setup(d_in, d_out)
    for a, b in zip(_jax_grads("xla", layers, x, cot), _port_grads(layers, x, cot)):
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b / scale, a / scale, atol=1e-4)


def test_grads_vs_tpu_kernel_at_its_bar():
    """tests/test_predictor_kernel.py:30-75 with the port's plain version as
    the f32 reference: the bf16 kernel's worst mean error under 1.5x the
    bf16-XLA path's + 1e-4, every leaf within cosine 0.99, d x mean error
    under 0.02 of its max."""
    layers, x, cot = _setup(259, 3, (700,))
    g32 = _port_grads(layers, x, cot)
    gbf = _jax_grads("bf16", layers, x, cot)
    gk = _jax_grads("fused", layers, x, cot)

    def worst_mean_rel(ga, gb):
        return max(float((np.abs(a - b) / (np.abs(a).max() + 1e-8)).mean()) for a, b in zip(ga, gb))

    assert worst_mean_rel(g32[:-1], gk[:-1]) < 1.5 * worst_mean_rel(g32[:-1], gbf[:-1]) + 1e-4
    for a, b in zip(g32, gk):
        a, b = a.ravel(), b.ravel()
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12) > 0.99
    assert (np.abs(g32[-1] - gk[-1]) / (np.abs(g32[-1]).max() + 1e-8)).mean() < 0.02


def test_odd_row_count_and_leading_shape():
    layers, x, _ = _setup(72, 3, (3, 7))   # 21 rows, ragged
    ref = np.asarray(apply_jax(layers, jnp.asarray(x), activation="none"))
    with torch.no_grad():
        out = K.predictor(from_numpy_tree(layers), torch.from_numpy(x))
    assert out.shape == (3, 7, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-4)


def test_packing_round_trip_and_bounds():
    """The kernel layout (w1 padded to a multiple of 16 rows, w4 to 16
    columns, biases [4, 256]) holds the weights unchanged up to bf16."""
    layers, _, _ = _setup(123, 3)
    p = from_numpy_tree(layers)
    from nero_tpu_torch.ops.mlp import resolve_weight_norm
    res = resolve_weight_norm(p)
    ws, bs = [l["w"].detach() for l in res], [l["b"].detach() for l in res]
    assert K.supported(ws) and K.padded_d_in(123) == 128 and K.padded_d_in(259) == 272
    W, B = K.pack_weights(ws, bs)
    assert W.dtype == torch.bfloat16 and W.numel() == 128 * 256 + 2 * 256 * 256 + 256 * 16
    w1 = W[:128 * 256].view(128, 256).float()
    torch.testing.assert_close(w1[:123], ws[0].to(torch.bfloat16).float(), atol=0, rtol=0)
    assert torch.all(w1[123:] == 0)
    w4 = W[-256 * 16:].view(256, 16).float()
    assert torch.all(w4[:, 3:] == 0)
    torch.testing.assert_close(B[3, :3], bs[3], atol=0, rtol=0)
    assert K.flops(10, 259, 3) == 2.0 * 10 * (259 * 256 + 2 * 256 * 256 + 256 * 3)
    # the backward: the hidden layers' recompute (the output layer's value is
    # not needed), dW of all four layers, the cotangents down to the input
    assert K.flops(10, 259, 3, backward=True) == 2.0 * 10 * (
        3 * 259 * 256 + 6 * 256 * 256 + 2 * 256 * 3)
    assert K.bwd_flops_per_row(259, 3, want_dx=False) == 2.0 * (
        2 * 259 * 256 + 6 * 256 * 256 + 2 * 256 * 3)
    assert not K.supported([torch.zeros(300, 256), *ws[1:]])


# ---------------------------------------------------------------------------
# the forward's weight stream and shared memory: a mirror of csrc/predictor.cu
# ---------------------------------------------------------------------------

SMEM_MAX = 232448  # a block's shared memory on the H100
SLAB_REC = 12      # SlabRec: unsigned offset, four unsigned shorts


def _read(fn):
    with open(os.path.join(cuda_build.CSRC, fn)) as f:
        return f.read()


def _source_constants() -> dict:
    out = {}
    for fn, keys in (("predictor.cu", ("PB", "BTHREADS", "MAX_DI", "DO")),
                     ("engine.cuh", ("LAYER_W", "WN", "SLAB_K", "STAGES"))):
        src = _read(fn)
        out.update({k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                    for k in keys})
    return out


def forward_stream(di: int, c: dict) -> list:
    """(element offset, rows, columns) of each slab of the forward, as
    csrc/predictor.cu::fwd_slab_at lays them out: W1 in slabs of up to
    SLAB_K rows, W2 and W3 in SLAB_K-row slabs, then W4 [256, 16] as
    SLAB_K-row slabs of its 16 columns."""
    h, k, do = c["LAYER_W"], c["SLAB_K"], c["DO"]
    off = [0, di * h, di * h + h * h, di * h + 2 * h * h]
    s = [(r * h, min(k, di - r), h) for r in range(0, di, k)]
    s += [(off[l] + r * h, k, h) for l in (1, 2) for r in range(0, h, k)]
    return s + [(off[3] + r * do, k, do) for r in range(0, h, k)]


@pytest.mark.parametrize("d_in", sorted({d for d, _ in K.SHADER_SHAPES}))
def test_forward_weight_stream_and_smem(d_in):
    """ceil(di / 128) + 6 slabs that stream every packed weight once, in
    order, each within a stage of the ring (SLAB_K rows of LAYER_W + 8);
    128-row tiles (the wrapper's TILE) of 16 warps, 32 rows x 64 columns
    each, whose first two n8-tiles hold W4's 16 columns; the tile, the ring
    and the slab table within a block's 232,448 bytes at the widest input."""
    c = _source_constants()
    assert c["PB"] == K.TILE == 128 and c["MAX_DI"] == K.MAX_D_IN
    assert c["BTHREADS"] == 4 * c["PB"] and c["BTHREADS"] // 32 == c["PB"] // 32 * 4
    assert c["DO"] == K.DO and c["DO"] <= 8 * c["WN"] and c["DO"] % 16 == 0
    di = K.padded_d_in(d_in)
    stream = forward_stream(di, c)
    assert len(stream) == -(-di // 128) + 6
    ends = [o + r * cols for o, r, cols in stream]
    assert stream[0][0] == 0 and [o for o, _, _ in stream[1:]] == ends[:-1]
    assert ends[-1] == sum(r * cols for _, r, cols in stream) == (
        di * 256 + 2 * 256 * 256 + 256 * K.DO)
    stage = max(c["SLAB_K"] * (c["LAYER_W"] + 8), c["LAYER_W"] * (c["SLAB_K"] + 8))
    assert all(r <= c["SLAB_K"] and r * (c["LAYER_W"] + 8) <= stage and cols % 8 == 0
               for _, r, cols in stream)
    n_max = len(forward_stream(c["MAX_DI"], c))
    smem = (c["PB"] * (c["MAX_DI"] + 8) * 2 + c["STAGES"] * stage * 2 + n_max * SLAB_REC)
    assert n_max == 9 and smem <= SMEM_MAX, smem


def test_the_forward_runs_on_the_engine():
    """csrc/predictor.cu's C entry `predictor_fwd` launches
    `predictor_fwd_kernel` on engine.cuh's ring and product, with no copy of
    them; the first version's rows kernel is gone, and so is common.cuh's
    `block_mm`, from every source; `kernel_variants`' `weights_only` takes
    the forward's epilogue with the recompute's."""
    from nero_tpu_torch import kernel_variants
    src = _read("predictor.cu")
    assert '#include "engine.cuh"' in src and "predictor_fwd_kernel<<<" in src
    assert "predictor_rows_kernel" not in src
    for copy in ("struct Ring", "void product(", "struct SlabRec"):
        assert copy not in src
    assert src.count(kernel_variants._PR_FWD_EPILOGUE) == 2
    for fn in os.listdir(cuda_build.CSRC):
        if fn.endswith((".cu", ".cuh")):
            assert "block_mm" not in _read(fn), fn


@pytest.mark.gpu
@pytest.mark.parametrize("d_in,d_out", K.SHADER_SHAPES)
def test_cuda_kernel_matches_plain_version(d_in, d_out):
    """n = 1001 (ragged for the 128-row tile) and 0: the forward within the
    TPU kernel's bar of the plain version and at the emulation of its
    rounding points (bf16 X and H, f32 sums): the same rounding points with
    the sums in another order, so most outputs agree to the f32 sums' noise
    (median |d| <= 1e-6), and an H element whose sum lies at a bf16 rounding
    boundary may round the other way and move its row by ~1e-4 (max |d| <=
    1e-3); the same bits in two calls; no rows give an empty output and
    count no launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    layers, x, _ = _setup(d_in, d_out, (1001,))
    dev = torch.device("cuda")
    p = from_numpy_tree(layers, device=dev)
    xt = torch.from_numpy(x).to(dev)
    with torch.no_grad():
        got = K.predictor(p, xt)
        torch.testing.assert_close(got, K.predictor_plain(p, xt), atol=2e-3, rtol=1e-2)
        emu = _kernel_head(resolve_weight_norm(from_numpy_tree(layers)), torch.from_numpy(x))
        d = (got.cpu() - emu).abs()
        assert d.median().item() <= 1e-6 and d.max().item() <= 1e-3, (d.median(), d.max())
        assert torch.equal(got, K.predictor(p, xt))
        counted = dict(K.launches)
        assert K.predictor(p, xt[:0]).shape == (0, d_out)
        assert K.launches == counted
