"""The value-only SDF function of the port (ops/sdf_fwd.py, its plain
version: the CUDA kernel runs on the card only) against nero_tpu's
`sdf_value` in f32 and against the TPU kernel `sdf_fwd_fused` in interpret
mode at that kernel's own bar (atol 2e-2: bf16 operands), and
`make_nograd_sdf_fn` with the switch on and off; a mirror of the kernel's
weight stream, shared memory and tile rule against the constants of
csrc/sdf_fwd.cu and csrc/sdf_net.cuh, and the sources' shape: B6 and B1 on
the one engine of sdf_net.cuh."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nero_tpu.fields.sdf import SDFConfig as JCfg, init_sdf, sdf_value as sdf_value_jax
from nero_tpu.ops.pallas.sdf_kernel import pack_sdf_params, sdf_fwd_fused
from nero_tpu_torch.core.convert import from_numpy_tree
from nero_tpu_torch.fields.sdf import SDFConfig
from nero_tpu_torch.ops import cuda_build
from nero_tpu_torch.ops import sdf_fwd as K
from nero_tpu_torch.ops.sdf_grad import sdf_with_grad
from nero_tpu_torch.ops.mlp import resolve_weight_norm
from nero_tpu_torch.render import shape as T
from torch_csrc import source_constants

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def params_j():
    return jax.tree_util.tree_map(np.asarray, init_sdf(jax.random.PRNGKey(0), JCfg()))


def _pts(shape, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, shape + (3,)).astype(np.float32)


@pytest.mark.parametrize("shape,scale", [((600,), 1.0), ((601,), 1.0), ((3, 7), 1.0),
                                         ((2, 5, 11), 1.0), ((600,), 1.3)],
                         ids=["n600", "odd_n", "2d", "3d", "scale"])
def test_plain_matches_jax_f32_and_tpu_kernel(params_j, shape, scale):
    pts = _pts(shape)
    jcfg, cfg = JCfg(scale=scale), SDFConfig(scale=scale)
    pj = jax.tree_util.tree_map(jnp.asarray, params_j)
    ref = np.asarray(sdf_value_jax(pj, jnp.asarray(pts), jcfg))
    out = K.sdf_fwd(from_numpy_tree(params_j), torch.from_numpy(pts), cfg)
    assert out.shape == shape + (1,) and not out.requires_grad
    # f32 on both sides: summation order only
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=1e-4)
    fused = np.asarray(sdf_fwd_fused(pack_sdf_params(pj, jcfg), jnp.asarray(pts), jcfg,
                                     interpret=True))
    # tests/test_pallas_kernels.py:19: bf16 operands in the TPU kernel
    np.testing.assert_allclose(out.numpy(), fused, atol=2e-2)
    assert np.abs(out.numpy() - fused).mean() < 3e-3


def test_resolved_weights_and_no_grad(params_j):
    """Callers hand over resolved {w, b} layers (render resolves once); the
    result is the same and carries no graph."""
    pts = torch.from_numpy(_pts((64,)))
    p = from_numpy_tree(params_j)
    a = K.sdf_fwd(p, pts)
    b = K.sdf_fwd(resolve_weight_norm(p), pts.clone().requires_grad_(True))
    assert not b.requires_grad
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("on", [False, True])
def test_make_nograd_sdf_fn(params_j, on):
    scfg = T.shape_config_from_dict({"use_fused_sdf": on})
    assert scfg.use_fused_sdf is on
    params = {"sdf": resolve_weight_norm(from_numpy_tree(params_j))}
    fn = T.make_nograd_sdf_fn(params, scfg)
    pts = _pts((5, 9))
    ref = np.asarray(sdf_value_jax(jax.tree_util.tree_map(jnp.asarray, params_j),
                                   jnp.asarray(pts), JCfg()))
    with torch.no_grad():
        out = fn(torch.from_numpy(pts))
    assert out.shape == (5, 9, 1)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=1e-4)
    before = dict(K.launches)
    fn(torch.from_numpy(pts))
    assert K.launches == before, "a CPU tensor must not count as a kernel launch"


def test_unsupported_topology_raises_when_packing(params_j):
    """multires 21 is past nero_tpu's PE_PAD of 128: packing raises; multires
    4 packs to its own layout (27 PE channels padded to 32)."""
    with pytest.raises(NotImplementedError):
        K.pack_params(from_numpy_tree(params_j), SDFConfig(multires=21))
    from nero_tpu_torch.fields.sdf import init_sdf
    cfg4 = SDFConfig(multires=4)
    W, bias = K.pack_params(init_sdf(torch.Generator().manual_seed(0), cfg4), cfg4)
    assert W.numel() == sum(r * c for r, c in K.layout(4).pack_shapes) and bias.shape == (9, 272)


def test_bound_inputs():
    # 2 x (39*256 + 2*256*256 + 2*256*217 + 39*256 + 3*256*256 + 256) per point
    assert K.flops(1) == 2.0 * 459008
    assert K.min_bytes(131072) == 131072 * 16 + 2 * sum(r * c for r, c in K.PACK_SHAPES)


# ---------------------------------------------------------------------------
# the weight stream, shared memory and tile rule: a mirror of csrc/sdf_fwd.cu
# ---------------------------------------------------------------------------

SMEM_MAX = 232448  # a block's shared memory on the H100


def _read(fn):
    with open(os.path.join(cuda_build.CSRC, fn)) as f:
        return f.read()


def _source_constants(multires: int = 6) -> dict:
    """sdf_net.cuh's constants at the build of `multires`."""
    return source_constants(("sdf_net.cuh",), ("HID", "PEW", "OUTW", "NPE", "WN", "SLAB_K",
                                               "STAGES", "SDF_COLS"),
                            {"NERO_SDF_MULTIRES": multires})


def value_stream(c: dict) -> list:
    """(element offset, rows, columns, row stride in the packed weights) of
    each slab of the kernel's stream, as sdf_net.cuh::slab_at<VALUE_STREAM>
    lays them out: w0, w1 w2 w3 w4a, w4b, w5 w6 w7 in slabs of up to SLAB_K
    rows, in the packed order; then of w8 [256, 272] the sdf column's
    n8-tile alone, SLAB_K rows a slab."""
    h, pe, k = c["HID"], c["PEW"], c["SLAB_K"]
    sizes = [r * cols for r, cols in K.PACK_SHAPES]
    offs = [sum(sizes[:i]) for i in range(len(sizes))]
    s = []
    for p in range(9):  # w0 .. w7 with w4b: the first nine packed products
        rows = pe if p in (0, 5) else h
        s += [(offs[p] + r * h, min(k, rows - r), h, h) for r in range(0, rows, k)]
    return s + [(offs[9] + r * c["OUTW"], k, c["SDF_COLS"], c["OUTW"]) for r in range(0, h, k)]


def test_weight_stream_and_smem():
    """The stream reads w0 .. w7 whole and in order, then w8's first 8
    columns (4 KB of its 139 KB): 18 slabs, each within a stage of the ring
    (SLAB_K rows of OUTW + 8) and inside the packed weights; the tile of 128
    points (and of 64) with its PE and the ring within a block's 232,448
    bytes."""
    c = _source_constants()
    assert (c["HID"], c["PEW"], c["OUTW"], c["NPE"]) == (256, 48, 272, 39)
    stream = value_stream(c)
    assert len(stream) == 18
    hidden = stream[:-2]
    ends = [o + r * cols for o, r, cols, _ in hidden]
    assert hidden[0][0] == 0 and [o for o, _, _, _ in hidden[1:]] == ends[:-1]
    assert ends[-1] == sum(r * cols for r, cols in K.PACK_SHAPES[:9])
    w8 = stream[-2:]
    assert c["SDF_COLS"] == 8 and all(cols == c["SDF_COLS"] for _, _, cols, _ in w8)
    assert sum(r * cols for _, r, cols, _ in w8) * 2 == 4096
    total = sum(r * cols for r, cols in K.PACK_SHAPES)
    stage = max(c["SLAB_K"] * (c["OUTW"] + 8), c["HID"] * (c["SLAB_K"] + 8))
    for off, rows, cols, ldg in stream:
        assert rows <= c["SLAB_K"] and rows * (c["OUTW"] + 8) <= stage and cols % 8 == 0
        assert off + (rows - 1) * ldg + cols <= total
    for points in (K.TILE, K.SMALL_TILE):
        smem = (points * (c["HID"] + 8) + points * (c["PEW"] + 8) + c["STAGES"] * stage) * 2
        assert smem <= SMEM_MAX, (points, smem)
    # 16 warps: 4 row groups x 4 column groups of 64, MT m16 tiles a warp
    assert c["HID"] // (8 * c["WN"]) == 4 and K.TILE == 4 * 16 * 2 and K.SMALL_TILE == 4 * 16


@pytest.mark.parametrize("sms", [132, 114, 1])
def test_tile_rule(sms):
    """64 points a tile when the launch is one wave of them, else 128: on an
    H100's 132 SMs the 8,192-point up-sample passes run 128 tiles of 64, the
    32,768- and 131,072-point passes tiles of 128; the source states the
    same rule."""
    thr = K.SMALL_TILE * sms
    assert K.tile(1, sms) == K.tile(thr, sms) == K.SMALL_TILE
    assert K.tile(thr + 1, sms) == K.tile(K.TILE * sms, sms) == K.TILE
    if sms == 132:
        assert [K.tile(n, sms) for n in (8192, 8448, 8449, 32768, 131072)] == [64, 64, 128,
                                                                              128, 128]
    assert "int sdf_fwd_tile(int n, int sms) { return (n + 63) / 64 <= sms ? 64 : 128; }" in (
        _read("sdf_fwd.cu"))


def test_both_kernels_run_on_the_shared_engine():
    """sdf_fwd.cu (B6) and sdf_grad.cu (B1) take the ring, the product, the
    PE and the hidden layers from sdf_net.cuh and keep no copy; B6 streams
    its own table (VALUE_STREAM) with one row kind, B1 four; no source holds
    common.cuh's `block_mm` any more."""
    engine = _read("sdf_net.cuh")
    for part in ("struct Ring {", "void product(", "float div_beta(", "void pe_tile(",
                 "void hidden_layers(", "Slab slab_at("):
        assert engine.count(part) == 1, part
    for fn, kinds in (("sdf_fwd.cu", "1, MT"), ("sdf_grad.cu", "4, 2")):
        src = _read(fn)
        assert '#include "sdf_net.cuh"' in src
        for part in ("struct Ring", "void product(", "div_beta(float", "void pe_tile(",
                     "void hidden_layers(", "void cp_async16(", "void mma_bf16("):
            assert part not in src, (fn, part)
        assert f"hidden_layers<{kinds}>(" in src and f"pe_tile<{kinds}>(" in src
    assert "Ring<VALUE_STREAM>" in _read("sdf_fwd.cu")
    assert "Ring<FWD_STREAM>" in _read("sdf_grad.cu") and "Ring<BWD_STREAM>" in _read("sdf_grad.cu")
    for fn in os.listdir(cuda_build.CSRC):
        if fn.endswith((".cu", ".cuh")):
            assert "block_mm" not in _read(fn), fn


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version(params_j):
    """3 x 1001 points (ragged for both tiles, padded for B1): within the
    TPU kernel's bar of the plain version, and equal to the bit to the sdf
    of the SDF-with-gradient kernel, which runs the same arithmetic."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    p = from_numpy_tree(params_j, device=dev)
    pts = torch.from_numpy(_pts((3, 1001))).to(dev)
    with torch.no_grad():
        out, ref = K.sdf_fwd(p, pts), K.sdf_fwd_plain(p, pts)
        b1 = sdf_with_grad(p, pts)[0]
    assert out.shape == (3, 1001, 1)
    torch.testing.assert_close(out, ref, atol=2e-2, rtol=0)
    assert torch.equal(out, b1)
