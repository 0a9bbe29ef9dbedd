"""SDF with its spatial gradient: the CUDA kernel and its plain version.

Replaces nero_tpu/ops/pallas/sdf_grad_kernel.py::sdf_with_grad_fused (:469),
whose pallas_calls are nero_sdf_grad_fwd (:363) and nero_sdf_grad_bwd
(:387). The kernel source is csrc/sdf_grad.cu; its header comment gives the
design. `sdf_with_grad(..., mode)` computes the gradient by the mode that
the configuration resolved (render/shape.py::ShapeConfig.grad_mode), as
nero_tpu's three modes do:

* `fused`: the kernel for a CUDA tensor; its plain version
  (`sdf_with_grad_plain`) for a CPU tensor, and only then;
* `rev`: `sdf_with_grad_plain` on any device: reverse-mode double backprop
  through `torch.autograd.grad(create_graph=True)`;
* `fwd`: `sdf_with_grad_fwd` on any device: forward-mode tangents along the
  three axes (fields/sdf.py::sdf_apply_fwd).

`rev` and `fwd` store and multiply as ops/mlp.py's contexts say.

What bounds it on the card: tensor-core operations (`flops`), about
0.25 ms forward and 0.75 ms backward at N = 65,536 and 989 TFLOP/s; the
bytes it must move (points in, sdf/feats/grad out) are ~70 MB, 0.02 ms.

Gradients flow to the resolved weights (and through weight norm to v, g);
none flows to the points: z values are detached upstream, as on the TPU.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from nero_tpu_torch.fields.sdf import SDFConfig, sdf_apply, sdf_apply_fwd
from nero_tpu_torch.ops import cuda_build
from nero_tpu_torch.ops.mlp import resolve_weight_norm

TILE = 32        # points per block (csrc/sdf_grad.cu P)
PE_W = 48        # 39 PE channels padded
HID = 256
OUT_W = 272      # 257 outputs padded
SKIP_W = 217     # 256 - 39
N_PE = 39
WIDTHS = (256, 256, 256, SKIP_W, 256, 256, 256, 256, 257)  # out width per layer
# packed layout: (rows, cols) of w0 w1 w2 w3 w4a w4b w5 w6 w7 w8
PACK_SHAPES = ((PE_W, HID), (HID, HID), (HID, HID), (HID, HID), (HID, HID),
               (PE_W, HID), (HID, HID), (HID, HID), (HID, HID), (HID, OUT_W))

launches = {"sdf_grad_fwd": 0, "sdf_grad_bwd": 0}
# FLOPs of every counted launch, by `flops(...)` at the launch's shapes (core/mfu.py)
flop_tally = dict.fromkeys(launches, 0.0)
GRAD_MODES = ("rev", "fwd", "fused")


def supported(cfg: SDFConfig) -> bool:
    return (cfg.n_layers == 8 and cfg.skip == 4 and cfg.d_hidden == 256
            and cfg.d_out == 257 and cfg.multires == 6 and cfg.weight_norm)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def sdf_with_grad_plain(params, x: torch.Tensor, cfg: SDFConfig = SDFConfig()):
    """(sdf [...,1], feats [...,d_out-1], grad [...,3]); grad = d sdf / dx,
    differentiable when grad mode is on (second order works through it)."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        out = sdf_apply(params, xg, cfg)
        (grad,) = torch.autograd.grad(out[..., 0].sum(), xg, create_graph=create)
    if not create:
        out = out.detach()
    return out[..., :1], out[..., 1:], grad


def sdf_with_grad_fwd(params, x: torch.Tensor, cfg: SDFConfig = SDFConfig()):
    """(sdf [...,1], feats [...,d_out-1], grad [...,3]) by forward-mode
    tangents (nero_tpu/fields/sdf.py:118-122); differentiable in the
    weights when grad mode is on."""
    out, grad = sdf_apply_fwd(params, x.detach(), cfg)
    return out[..., :1], out[..., 1:], grad


# ---------------------------------------------------------------------------
# kernel plumbing
# ---------------------------------------------------------------------------


def _lib():
    lib = cuda_build.load("sdf_grad")
    if not getattr(lib, "_nero_typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sdf_grad_weight_elems.restype = ctypes.c_size_t
        lib.sdf_grad_weight_elems.argtypes = []
        lib.sdf_grad_tile.restype = i
        lib.sdf_grad_tile.argtypes = []
        lib.sdf_grad_scratch_elems.restype = ctypes.c_size_t
        lib.sdf_grad_scratch_elems.argtypes = [i]
        lib.sdf_grad_part_elems.restype = ctypes.c_size_t
        lib.sdf_grad_part_elems.argtypes = [i]
        lib.sdf_grad_fwd.restype = i
        lib.sdf_grad_fwd.argtypes = [vp, i, vp, vp, f, f, vp, vp, vp, vp]
        lib.sdf_grad_bwd.restype = i
        lib.sdf_grad_bwd.argtypes = [vp, i, vp, vp, f, f, vp, vp, vp, vp, vp, vp, vp, vp]
        lib.sdf_grad_bwd_sweep.restype = i
        lib.sdf_grad_bwd_sweep.argtypes = [vp, i, vp, vp, f, f, vp, vp, vp, vp, vp]
        lib.sdf_grad_bwd_params.restype = i
        lib.sdf_grad_bwd_params.argtypes = [i, vp, vp, vp, vp, vp]
        if (lib.sdf_grad_tile() != TILE
                or lib.sdf_grad_weight_elems() != sum(r * c for r, c in PACK_SHAPES)):
            raise RuntimeError("csrc/sdf_grad.cu layout differs from ops/sdf_grad.py")
        lib._nero_typed = True
    return lib


def pack_weights(ws, bs):
    """Resolved weights [in,out] / biases -> (packed bf16 [W_TOTAL], bias f32
    [9, OUT_W]) in the kernel layout; the skip layer is split into its h3
    part (w4a) and its PE part (w4b), both scaled by 1/sqrt(2)."""
    inv_s2 = 1.0 / math.sqrt(2.0)

    def pad(a, rows, cols):
        return F.pad(a, (0, cols - a.shape[1], 0, rows - a.shape[0]))

    parts = [ws[0], ws[1], ws[2], ws[3], ws[4][:SKIP_W] * inv_s2,
             ws[4][SKIP_W:] * inv_s2, ws[5], ws[6], ws[7], ws[8]]
    packed = torch.cat([pad(p, r, c).reshape(-1)
                        for p, (r, c) in zip(parts, PACK_SHAPES)])
    bias = torch.zeros(9, OUT_W, dtype=torch.float32, device=ws[0].device)
    for l, b in enumerate(bs):
        bias[l, :b.shape[0]] = b
    return packed.to(torch.bfloat16).contiguous(), bias


def unpack_grads(dW: torch.Tensor, db: torch.Tensor):
    """Kernel-layout gradients -> per-layer (dw [in,out], db [out])."""
    inv_s2 = 1.0 / math.sqrt(2.0)
    sizes = [r * c for r, c in PACK_SHAPES]
    g = [t.view(r, c) for t, (r, c) in zip(torch.split(dW, sizes), PACK_SHAPES)]
    dws = [g[0][:N_PE], g[1], g[2], g[3][:, :SKIP_W],
           torch.cat([g[4][:SKIP_W] * inv_s2, g[5][:N_PE] * inv_s2]),
           g[6], g[7], g[8], g[9][:, :257]]
    dbs = [db[l, :w] for l, w in enumerate(WIDTHS)]
    return dws, dbs


def _fwd(pts, W, bias, beta, scale):
    n_pad = pts.shape[0]
    dev = pts.device
    sdf = torch.empty(n_pad, device=dev)
    grad = torch.empty(n_pad, 3, device=dev)
    feats = torch.empty(n_pad, HID, device=dev)
    rc = _lib().sdf_grad_fwd(pts.data_ptr(), n_pad, W.data_ptr(), bias.data_ptr(), beta,
                             scale, sdf.data_ptr(), grad.data_ptr(), feats.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "sdf_grad_fwd")
    launches["sdf_grad_fwd"] += 1
    flop_tally["sdf_grad_fwd"] += flops(n_pad)
    return sdf, grad, feats


def bwd_buffers(n_pad: int, dev):
    """The backward's scratch (bf16: H, GZ, layer 8's cotangent rows, the PE)
    and its per-chunk partials (f32), one torch.empty each."""
    lib = _lib()
    return (torch.empty(lib.sdf_grad_scratch_elems(n_pad), dtype=torch.bfloat16, device=dev),
            torch.empty(lib.sdf_grad_part_elems(n_pad), device=dev))


def _bwd(pts, W, bias, beta, scale, g_sdf, g_grad, g_feats):
    n_pad = pts.shape[0]
    dev = pts.device
    lib = _lib()
    scratch, part = bwd_buffers(n_pad, dev)
    dW = torch.zeros(W.numel(), device=dev)  # zero rows: the kernel writes nothing
    db = torch.zeros(9, OUT_W, device=dev)
    rc = lib.sdf_grad_bwd(pts.data_ptr(), n_pad, W.data_ptr(), bias.data_ptr(), beta, scale,
                          g_sdf.data_ptr(), g_grad.data_ptr(), g_feats.data_ptr(),
                          scratch.data_ptr(), part.data_ptr(), dW.data_ptr(),
                          db.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "sdf_grad_bwd")
    launches["sdf_grad_bwd"] += 1
    flop_tally["sdf_grad_bwd"] += flops(n_pad, backward=True)
    return dW, db


def _pad_rows(t: torch.Tensor, n_pad: int) -> torch.Tensor:
    t = t.float().contiguous()
    if t.shape[0] == n_pad:
        return t
    return torch.cat([t, t.new_zeros((n_pad - t.shape[0],) + t.shape[1:])]).contiguous()


class _SdfGradFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pts, beta, scale, *wb):
        n = pts.shape[0]
        n_pad = -(-n // TILE) * TILE
        W, bias = pack_weights(wb[:9], wb[9:])
        pts_p = _pad_rows(pts, n_pad)
        sdf, grad, feats = _fwd(pts_p, W, bias, beta, scale)
        ctx.save_for_backward(pts_p, W, bias)
        ctx.n, ctx.beta, ctx.scale = n, beta, scale
        return sdf[:n, None], feats[:n], grad[:n]

    @staticmethod
    def backward(ctx, g_sdf, g_feats, g_grad):
        pts_p, W, bias = ctx.saved_tensors
        n, n_pad = ctx.n, pts_p.shape[0]

        def cot(g, shape):
            if g is None:
                return torch.zeros((n_pad,) + shape, device=pts_p.device)
            return _pad_rows(g.reshape((n,) + shape), n_pad)

        dW, db = _bwd(pts_p, W, bias, ctx.beta, ctx.scale, cot(g_sdf, ()),
                      cot(g_grad, (3,)), cot(g_feats, (HID,)))
        dws, dbs = unpack_grads(dW, db)
        return (None, None, None, *dws, *dbs)


def sdf_with_grad(params, x: torch.Tensor, cfg: SDFConfig = SDFConfig(), mode: str = "fused"):
    """(sdf [...,1], feats [...,d_out-1], grad [...,3]) by `mode`: `fused`
    is the CUDA kernel for a CUDA tensor and the plain version for a CPU
    tensor; `rev` and `fwd` are plain on any device."""
    if mode not in GRAD_MODES:
        raise ValueError(f"sdf_grad_mode must be one of {GRAD_MODES}, got {mode!r}")
    if mode == "fwd":
        return sdf_with_grad_fwd(params, x, cfg)
    if mode == "rev" or x.device.type == "cpu":
        return sdf_with_grad_plain(params, x, cfg)
    if not supported(cfg):
        raise NotImplementedError(f"sdf_grad kernel needs the default topology, got {cfg}")
    layers = resolve_weight_norm(params)
    ws = [l["w"] for l in layers]
    bs = [l["b"] for l in layers]
    shape = x.shape[:-1]
    sdf, feats, grad = _SdfGradFn.apply(x.reshape(-1, 3).detach(), float(cfg.beta),
                                        float(cfg.scale), *ws, *bs)
    return (sdf.reshape(*shape, 1), feats.reshape(*shape, HID), grad.reshape(*shape, 3))


# ---------------------------------------------------------------------------
# the least work the function needs (for the bound beside the kernel time)
# ---------------------------------------------------------------------------

# in x out of the products of layers 0-7 (w4 as w4a on h3 and w4b on the
# PE), at the true (unpadded) widths; all 4 stacked rows need them
_KN_HID = (N_PE * 256 + 2 * 256 * 256 + 256 * SKIP_W + SKIP_W * 256 + N_PE * 256
           + 3 * 256 * 256)
# layer 8 (256 x 257) for the primal row; a tangent row needs only the sdf
# column (grad = d sdf / dx), 256 x 1
_KN_LAST = 256 * 257 + 3 * 256
# per point: the forward; and the cotangents GZ @ W^T of layers 8..1 (no PE
# cotangent), whose layer 8 has the same primal/tangent split
_KN_FWD = 4 * _KN_HID + _KN_LAST
_KN_GH = 4 * (_KN_HID - 2 * N_PE * 256) + _KN_LAST


def flops(n: int, backward: bool = False) -> float:
    """Tensor-core operations per call: the backward recomputes the forward,
    then the cotangent products and the weight-gradient products H^T GZ
    (as many as the forward's)."""
    kn = _KN_FWD + _KN_GH + _KN_FWD if backward else _KN_FWD
    return 2.0 * n * kn


def min_bytes(n: int, backward: bool = False) -> float:
    """Each input read once, each output written once (f32 points and
    cotangents, bf16 weights, f32 gradients)."""
    w = sum(r * c for r, c in PACK_SHAPES)
    if backward:
        return n * (3 + 1 + 3 + 256) * 4 + w * 2 + w * 4
    return n * 3 * 4 + w * 2 + n * (1 + 3 + 256) * 4
