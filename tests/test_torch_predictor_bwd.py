"""The predictor kernel's backward (csrc/predictor.cu: recompute and reverse
sweep, parameter pass, reduction) as far as the CPU can hold it: its
rounding points emulated in plain torch (`_kernel_head` of
tests/torch_shader_common.py: bf16 X, H and GZ, f32 sums, the ReLU mask from
the bf16 H, dx = GZ1 W1^T in f32), for every head shape of the Stage-I
shader, held against the port's f32 plain gradients and against nero_tpu's
`predictor_fused` in interpret mode at tests/test_predictor_kernel.py's
bars. Also the zero-row case of the wrapper, a mirror of the backward's
buffer sizes and weight stream against the constants of the sources, the
typing of the C entries and the patches of `nero_tpu_torch/kernel_variants.py
--kernel predictor`. The kernel itself is held against its plain version and
this emulation on the card by the `gpu`-marked test and by chip_smoke.py."""
import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nero_tpu.ops.mlp import apply_predictor as apply_jax, hidden_dtype, init_predictor
from nero_tpu.ops.pallas.predictor_kernel import predictor_fused
from nero_tpu_torch import kernel_variants
from nero_tpu_torch.core.convert import from_numpy_tree, tree_items
from nero_tpu_torch.ops import cuda_build
from nero_tpu_torch.ops import predictor as K
from nero_tpu_torch.ops.mlp import resolve_weight_norm
from torch_shader_common import _kernel_head

torch.set_num_threads(1)

SHAPES = list(K.SHADER_SHAPES)


def _setup(d_in, d_out, n):
    layers = jax.tree_util.tree_map(np.asarray,
                                    init_predictor(jax.random.PRNGKey(d_in), d_in, d_out))
    rng = np.random.default_rng(d_in + d_out + n)
    x = (rng.standard_normal((n, d_in)) * 0.5).astype(np.float32)
    cot = rng.standard_normal((n, d_out)).astype(np.float32)
    return layers, x, cot


def emulate_predictor(layers, x):
    """The head's pre-activation output with the kernel's rounding points in
    its backward; differentiable to the {v, g, b} leaves and to x."""
    return _kernel_head(resolve_weight_norm(layers), x)


def _port_grads(fn, layers, x, cot):
    p = from_numpy_tree(layers)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = (fn(p, xt) * torch.from_numpy(cot)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, [v for _, v in tree_items(p)] + [xt])]


def _jax_grads(kind, layers, x, cot):
    def loss(p, xx):
        if kind == "fused":
            return jnp.sum(predictor_fused(p, xx, interpret=True) * cot)
        with hidden_dtype(jnp.bfloat16):
            return jnp.sum(apply_jax(p, xx, activation="none") * cot)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(layers, jnp.asarray(x))
    gp = jax.tree_util.tree_map(np.asarray, gp)
    return [a for _, a in tree_items(gp)] + [np.asarray(gx)]


@functools.lru_cache(maxsize=None)
def _grads(d_in, d_out, n):
    """Gradients of one case, leaves then x: the port's f32 plain version,
    the emulation, nero_tpu's bf16 XLA path and its TPU kernel."""
    layers, x, cot = _setup(d_in, d_out, n)
    return {"plain": _port_grads(K.predictor_plain, layers, x, cot),
            "emulation": _port_grads(emulate_predictor, layers, x, cot),
            "bf16": _jax_grads("bf16", layers, x, cot),
            "fused": _jax_grads("fused", layers, x, cot)}


def _worst_mean_rel(ga, gb):
    return max(float((np.abs(a - b) / (np.abs(a).max() + 1e-8)).mean()) for a, b in zip(ga, gb))


def _cosines(ga, gb):
    out = []
    for a, b in zip(ga, gb):
        a, b = a.ravel(), b.ravel()
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        out.append(float(a @ b / denom) if denom >= 1e-12 else 1.0)
    return out


@pytest.mark.parametrize("reference", ["plain", "fused"])
@pytest.mark.parametrize("n", [300, 1001])
@pytest.mark.parametrize("d_in,d_out", SHAPES)
def test_rounding_points_hold_the_bar(d_in, d_out, n, reference):
    """Against the port's f32 plain gradients or nero_tpu's TPU kernel: the
    parameter leaves' worst mean error (over each leaf's max) under 1.5x that
    of the bf16 XLA path against f32 + 1e-4, every leaf and x within cosine
    0.99, and the mean error of d x under 0.02 of its max."""
    g = _grads(d_in, d_out, n)
    want, got = g[reference], g["emulation"]
    noise_bf16 = _worst_mean_rel(g["plain"][:-1], g["bf16"][:-1])
    assert _worst_mean_rel(want[:-1], got[:-1]) < 1.5 * noise_bf16 + 1e-4
    assert min(_cosines(want, got)) > 0.99
    assert _worst_mean_rel(want[-1:], got[-1:]) < 0.02
    # the emulation is no copy of the reference: bf16 moves every case a little
    assert max(float(np.abs(a - b).max()) for a, b in zip(want, got)) > 0.0


@pytest.mark.parametrize("d_in,d_out", SHAPES)
def test_zero_rows_give_zero_parameter_gradients(d_in, d_out):
    """No rows: an empty output and every parameter gradient exactly 0 (the
    CPU side of the wrapper; on the card nothing is launched, nothing is
    counted, and dW, dB stay zero)."""
    layers, _, _ = _setup(d_in, d_out, 1)
    p = from_numpy_tree(layers)
    out = K.predictor(p, torch.zeros(0, d_in))
    assert out.shape == (0, d_out)
    grads = torch.autograd.grad(out.sum(), [v for _, v in tree_items(p)], allow_unused=True)
    assert all(g is None or not g.any() for g in grads)


# ---------------------------------------------------------------------------
# the backward's buffers and weight stream: a mirror of csrc/predictor.cu
# ---------------------------------------------------------------------------


def _source_constants() -> dict:
    out = {}
    for fn, keys in (("predictor.cu", ("PB", "MAX_DI")),
                     ("engine.cuh", ("PW_RS", "PW_MIN_ROWS", "PW_MAX_CHUNKS", "LAYER_W",
                                     "SLAB_K", "STAGES"))):
        with open(os.path.join(cuda_build.CSRC, fn)) as f:
            src = f.read()
        out.update({k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                    for k in keys})
    return out


def weight_elems(di: int) -> int:
    return di * 256 + 2 * 256 * 256 + 256 * 16


def backward_sizes(n: int, d_in: int) -> tuple:
    """(bf16 elements of the scratch, floats of the partials) for n rows: X
    (di wide), H and GZ of layers 1-3 and GZ4 (16 wide) for n rounded up to
    the parameter pass's stage; one dW + dB [4, 256] per row chunk."""
    c = _source_constants()
    di = K.padded_d_in(d_in)
    m = -(-n // c["PW_RS"]) * c["PW_RS"]
    chunks = min(max(m // c["PW_MIN_ROWS"], 1), c["PW_MAX_CHUNKS"])
    return m * (di + 6 * 256 + 16), chunks * (weight_elems(di) + 4 * 256)


def weight_stream(di: int, dx: bool) -> list:
    """(element offset, rows, columns, ring row stride) of each slab of the
    sweep, as csrc/predictor.cu::slab_at lays them out: the recompute's W1,
    W2, W3 as [k][n] slabs of up to SLAB_K rows; the sweep's W4^T, W3^T,
    W2^T and (dx) W1^T as [n][k] slabs of SLAB_K columns, W1^T in passes of
    256 of its rows."""
    c = _source_constants()
    h, sk = c["LAYER_W"], c["SLAB_K"]
    ldb, ldt = h + 8, sk + 8
    off = [0, di * h, di * h + h * h, di * h + 2 * h * h]
    s = [(k * h, min(sk, di - k), h, ldb) for k in range(0, di, sk)]
    s += [(off[l] + j * sk * h, sk, h, ldb) for l in (1, 2) for j in range(h // sk)]
    s += [(off[3], h, 16, ldt)]
    s += [(off[l] + j * sk, h, sk, ldt) for l in (2, 1) for j in range(h // sk)]
    if dx:
        s += [(r0 * h + j * sk, min(h, di - r0), sk, ldt)
              for r0 in range(0, di, h) for j in range(h // sk)]
    return s


@pytest.mark.parametrize("d_in,d_out", SHAPES)
def test_backward_buffer_sizes_and_weight_stream(d_in, d_out):
    """The mirror at n = 1, 1001, 65,536: the tile and chunk constants the
    sources hold, and the sizes they give (239 MB of scratch at 65,536 rows
    and d_in 259, 3.6 KB a row). Every slab of the sweep fits a stage of the
    ring and lies inside the packed weights; at di = 272 W1^T takes two
    passes, since all its 272 rows would not fit one stage."""
    c = _source_constants()
    assert c["PB"] == K.TILE == 128 and c["PW_RS"] % c["PB"] == 0
    assert c["MAX_DI"] == K.MAX_D_IN
    di = K.padded_d_in(d_in)
    for n, m, chunks in ((1, 128, 1), (1001, 1024, 1), (65536, 65536, 32)):
        scratch, part = backward_sizes(n, d_in)
        assert scratch == m * (di + 1552) and part == chunks * (weight_elems(di) + 1024)
    if d_in == 259:
        assert backward_sizes(65536, d_in)[0] * 2 == 65536 * 3648
    stage = max(c["SLAB_K"] * (c["LAYER_W"] + 8), c["LAYER_W"] * (c["SLAB_K"] + 8))
    for dx in (False, True):
        stream = weight_stream(di, dx)
        # what the sweep's products take: W1 in ceil(di / 128) slabs, two each
        # of W2, W3, W3^T, W2^T, one of W4^T, two a pass of W1^T
        assert len(stream) == -(-di // 128) + 9 + (2 * -(-di // 256) if dx else 0)
        for off, rows, cols, lds in stream:
            assert rows * lds <= stage and cols % 8 == 0
            assert off + (rows - 1) * (16 if cols == 16 else 256) + cols <= weight_elems(di)
    assert len(weight_stream(272, True)) == 16  # MAX_SLABS in csrc/predictor.cu
    assert 272 * (c["SLAB_K"] + 8) > stage  # one W1^T slab of 272 rows would not fit


@pytest.mark.parametrize("kernel,name",
                         [("predictor", n) for n in kernel_variants.PREDICTOR_VARIANTS]
                         + [("sdf_fwd", n) for n in kernel_variants.SDF_FWD_VARIANTS])
def test_every_variant_patch_applies(kernel, name):
    """A stale patch shows only on the card: each variant's every (old, new)
    pair must find its text in csrc/predictor.cu, or in csrc/sdf_fwd.cu or
    the engine's csrc/sdf_net.cuh, as they are, and change it."""
    files = kernel_variants.variant_files(name, kernel)
    assert f"{kernel}.cu" in files
    assert set(files) <= {f"{kernel}.cu", *kernel_variants._HEADERS.get(kernel, ())}
    changed = False
    for fn, text in files.items():
        with open(os.path.join(cuda_build.CSRC, fn)) as f:
            changed = changed or text != f.read()
    assert changed == bool(kernel_variants._TABLES[kernel][name])


def _c_entries():
    """name -> argument count of every C entry of csrc/predictor.cu."""
    with open(os.path.join(cuda_build.CSRC, "predictor.cu")) as f:
        src = f.read()
    block = src[src.index('extern "C" {'):]
    return {m.group(1): len([a for a in m.group(2).split(",") if a.strip()])
            for m in re.finditer(r"^(?:int|size_t) (predictor_\w+)\(([^)]*)\)", block, re.M)}


@pytest.mark.parametrize("parts", [True, False])
def test_one_typing_covers_every_c_entry(parts):
    """`ops/predictor.py::type_lib` (the wrapper's and kernel_variants' one
    typing) gives every C entry of csrc/predictor.cu as many arguments as the
    source declares, and says whether the library has the backward's three
    parts; a library without them (an earlier source) is typed all the
    same."""
    entries = _c_entries()
    split = ("predictor_bwd_sweep", "predictor_bwd_params", "predictor_bwd_reduce")
    assert set(split) <= set(entries)
    lib = type("Lib", (), {})()
    for name in entries:
        if parts or name not in split:
            setattr(lib, name, type("Fn", (), {})())
    assert K.type_lib(lib) is parts
    for name, n_args in entries.items():
        if hasattr(lib, name):
            assert len(getattr(lib, name).argtypes) == n_args, name


def test_the_backward_runs_on_the_engine():
    """Three launches (sweep, parameter pass, reduction) on engine.cuh's ring,
    product and parameter pass, with no copy of them; common.cuh's
    weight-gradient pass is gone with its last caller."""
    with open(os.path.join(cuda_build.CSRC, "predictor.cu")) as f:
        src = f.read()
    assert '#include "engine.cuh"' in src
    for k in ("predictor_bwd_sweep_kernel", "predictor_bwd_params_kernel",
              "predictor_bwd_reduce_kernel"):
        assert f"{k}<<<" in src
    for copy in ("struct Ring", "void product(", "void param_pass(", "void reduce_chunks("):
        assert copy not in src
    with open(os.path.join(cuda_build.CSRC, "common.cuh")) as f:
        common = f.read()
    for gone in ("weight_grad", "bias_grad", "dw_partial", "colsum_partial", "reduce_kernel",
                 "part_elems", "dw_chunks"):
        assert gone not in common


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("d_in,d_out", SHAPES)
def test_cuda_backward_matches_plain_and_emulation(d_in, d_out):
    """n = 1001 (ragged for both tiles) and 0: the kernel's gradients against
    the plain version (cosine 0.99 per leaf and for x) and against the
    emulated rounding points (0.9999); the library's buffer sizes equal the
    mirror; two backward calls give the same dx, dW and dB to the bit, and
    one without dx the same dW and dB."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    n = 1001
    lib = K._lib()
    di = K.padded_d_in(d_in)
    for m in (1, 1001, 65536):
        assert (lib.predictor_scratch_elems(m, di),
                lib.predictor_part_elems(m, di)) == backward_sizes(m, d_in)
    layers, x_np, cot_np = _setup(d_in, d_out, n)
    p = from_numpy_tree(layers, device=dev)
    leaves = [v for _, v in tree_items(p)]
    x, gout = torch.from_numpy(x_np).to(dev), torch.from_numpy(cot_np).to(dev)
    with torch.no_grad():
        res = resolve_weight_norm(p)
        W, B = K.pack_weights([l["w"] for l in res], [l["b"] for l in res])
        got = K._bwd(x, W, B, gout)
        again = K._bwd(x, W, B, gout)
        no_dx = K._bwd(x, W, B, gout, want_dx=False)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert no_dx[0] is None and torch.equal(no_dx[1], got[1]) and torch.equal(no_dx[2], got[2])
    # the kernel's dW, dB to the parameter leaves through the weight norm,
    # resolved again with autograd on (the launches above ran without it)
    res = resolve_weight_norm(p)
    ws, bs = [l["w"] for l in res], [l["b"] for l in res]
    shapes = [(di, 256), (256, 256), (256, 256), (256, 16)]
    dW = [t.view(r, c) for t, (r, c) in zip(torch.split(got[1], [r * c for r, c in shapes]),
                                            shapes)]
    dws = [dW[0][:d_in], dW[1], dW[2], dW[3][:, :d_out]]
    dbs = [got[2][0], got[2][1], got[2][2], got[2][3, :d_out]]
    mine = list(torch.autograd.grad(ws + bs, leaves, dws + dbs)) + [got[0]]
    for fn, bar in ((K.predictor_plain, 0.99), (emulate_predictor, 0.9999)):
        xg = x.clone().requires_grad_(True)
        want = torch.autograd.grad(fn(p, xg), leaves + [xg], gout)
        assert min(_cosines([a.cpu().numpy() for a in want],
                            [b.cpu().numpy() for b in mine])) > bar
    counted = dict(K.launches)
    z = K._bwd(x[:0], W, B, gout[:0])
    assert z[0].shape == (0, d_in) and not z[1].any() and not z[2].any()
    assert K._fwd(x[:0], W, B, d_out).shape == (0, d_out)
    assert K.launches == counted  # no rows, no launch, no count
