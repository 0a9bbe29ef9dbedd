"""One 4-layer prediction head: the CUDA kernel and its plain version.

Replaces nero_tpu/ops/pallas/predictor_kernel.py::predictor_fused (:226),
whose pallas_calls are nero_predictor_fwd (:151) and nero_predictor_bwd
(:171). The kernel source is csrc/predictor.cu; its header comment gives the
design. `predictor` returns the head's pre-activation output; it launches the
kernel for a CUDA tensor and runs `predictor_plain` (plain torch, autograd)
for a CPU tensor, and only then. Gradients flow to x and, through the
resolved weights, to the {v, g, b} leaves. It is the `fused=True` body of
`ops/mlp.py::apply_predictor`, reached with `shader_config.fused_heads`.

What bounds it on the card: tensor-core operations (`flops`): at N = 65,536
and d_in 259 about 0.026 ms forward and 0.08 ms backward at 989 TFLOP/s; the
bytes (x in, out out) are 68 MB, 0.02 ms.

`predictor_scenes` is the same head over S scenes' layers stacked on a
leading axis (parallel/scenes.py), as nero_tpu's `jax.vmap` of the multi-
scene step batches the pallas_calls: one launch each way for all scenes, on
a grid with a scene dimension, the rows scene-major with n a scene; each
scene's outputs and gradients are its one-scene launch's to the bit. On a
CPU tensor it runs `predictor_plain` scene by scene.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from nero_tpu_torch.core.trace import traced
from nero_tpu_torch.ops import cuda_build
from nero_tpu_torch.ops.mlp import predictor_raw, resolve_weight_norm
from nero_tpu_torch.parallel.scenes import scene_map

TILE = 128       # rows per block, forward and backward (csrc/predictor.cu PB)
HID = 256
DO = 16          # outputs padded (csrc/predictor.cu DO)
MAX_D_IN = 272   # csrc/predictor.cu MAX_DI

# launches per head shape "<d_in>x<d_out>"; the Stage-I shader's shapes are
# listed up front so that a reader of the counters sees them at 0
# (`_scenes`: one launch for all scenes of the multi-scene step)
SHADER_SHAPES = ((259, 1), (259, 3), (72, 3), (144, 3), (123, 3), (90, 1), (24, 4))
launches = {f"predictor_{d}{sc}_{di}x{do}": 0 for sc in ("", "_scenes")
            for di, do in SHADER_SHAPES for d in ("fwd", "bwd")}


# FLOPs of every counted launch, by `flops(...)` at the launch's shapes (core/mfu.py)
flop_tally = dict.fromkeys(launches, 0.0)


def _count(direction: str, d_in: int, d_out: int, n: int, want_dx: bool = True) -> None:
    """direction: `fwd`, `bwd`, `fwd_scenes` or `bwd_scenes`; n the rows of
    all scenes of the launch."""
    key = f"predictor_{direction}_{d_in}x{d_out}"
    launches[key] = launches.get(key, 0) + 1
    flop_tally[key] = flop_tally.get(key, 0.0) + flops(n, d_in, d_out,
                                                       direction.startswith("bwd"), want_dx)


def predictor_plain(layers, x: torch.Tensor) -> torch.Tensor:
    """[..., d_in] -> [..., d_out], pre-activation, in plain torch."""
    return predictor_raw(layers, x)


def supported(ws) -> bool:
    return (len(ws) == 4 and ws[0].shape[1] == HID and ws[1].shape == (HID, HID)
            and ws[2].shape == (HID, HID) and ws[3].shape[0] == HID
            and ws[0].shape[0] <= MAX_D_IN and ws[3].shape[1] <= DO)


def padded_d_in(d_in: int) -> int:
    return -(-d_in // 16) * 16


def type_lib(lib) -> bool:
    """Give the library's C entries their ctypes signatures; returns whether
    it has the backward's three parts (`predictor_bwd_sweep`, `_params`,
    `_reduce`). An earlier source sizes its buffers by (m_rows, di) and
    (m_rows): at a row count that is a multiple of both tiles the sizes are
    the same, and the extra argument is ignored there."""
    vp, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    for name in ("predictor_tile", "predictor_max_d_in", "predictor_max_d_out"):
        getattr(lib, name).restype, getattr(lib, name).argtypes = i, []
    lib.predictor_weight_elems.restype, lib.predictor_weight_elems.argtypes = sz, [i]
    for fn in ("predictor_scratch_elems", "predictor_part_elems"):
        getattr(lib, fn).restype, getattr(lib, fn).argtypes = sz, [i, i]
    lib.predictor_fwd.restype = i
    lib.predictor_fwd.argtypes = [vp, i, i, i, i, vp, vp, vp, vp]
    lib.predictor_bwd.restype = i
    lib.predictor_bwd.argtypes = [vp, i, i, i, i, vp, vp, vp, vp, i, vp, vp, vp, vp, vp]
    if hasattr(lib, "predictor_fwd_scenes"):  # S scenes in one launch: n a scene, then S
        lib.predictor_fwd_scenes.restype = i
        lib.predictor_fwd_scenes.argtypes = [vp, i, i, i, i, i, vp, vp, vp, vp]
        lib.predictor_bwd_scenes.restype = i
        lib.predictor_bwd_scenes.argtypes = [vp, i, i, i, i, i, vp, vp, vp, vp, i, vp, vp, vp,
                                             vp, vp]
    parts = hasattr(lib, "predictor_bwd_sweep")
    if parts:
        lib.predictor_bwd_sweep.restype = i
        lib.predictor_bwd_sweep.argtypes = [vp, i, i, i, i, vp, vp, vp, vp, i, vp, vp]
        lib.predictor_bwd_params.restype = i
        lib.predictor_bwd_params.argtypes = [i, i, vp, vp, vp]
        lib.predictor_bwd_reduce.restype = i
        lib.predictor_bwd_reduce.argtypes = [i, i, vp, vp, vp, vp]
    return parts


def _lib():
    lib = cuda_build.load("predictor")
    if not getattr(lib, "_nero_typed", False):
        if not type_lib(lib) or not hasattr(lib, "predictor_fwd_scenes"):
            raise RuntimeError("csrc/predictor.cu has no predictor_bwd_sweep / _params / _reduce "
                               "or no predictor_fwd_scenes / predictor_bwd_scenes")
        if (lib.predictor_tile() != TILE
                or lib.predictor_max_d_in() != MAX_D_IN or lib.predictor_max_d_out() != DO):
            raise RuntimeError("csrc/predictor.cu layout differs from ops/predictor.py")
        lib._nero_typed = True
    return lib


def _shapes(di: int):
    return ((di, HID), (HID, HID), (HID, HID), (HID, DO))


def pack_weights(ws, bs):
    """4 resolved weights [in,out] / biases -> (packed bf16, bias f32 [4, 256])."""
    di = padded_d_in(ws[0].shape[0])
    parts = [F.pad(w, (0, c - w.shape[1], 0, r - w.shape[0])).reshape(-1)
             for w, (r, c) in zip(ws, _shapes(di))]
    bias = torch.zeros(4, HID, dtype=torch.float32, device=ws[0].device)
    for l, b in enumerate(bs):
        bias[l, :b.shape[0]] = b
    return torch.cat(parts).to(torch.bfloat16).contiguous(), bias


def _fwd(x, W, B, d_out: int) -> torch.Tensor:
    """One forward launch on packed weights, for one scene (x [n, d_in], W
    packed, B [4, 256]) or for S (a leading scene axis on each): -> [..., n,
    d_out]. A launch for scenes counts under `predictor_fwd_scenes_*`."""
    lead, (n, d_in) = x.shape[:-2], x.shape[-2:]
    S = math.prod(lead)
    out = torch.empty(lead + (n, d_out), device=x.device)
    rc = _lib().predictor_fwd_scenes(x.data_ptr(), n, S, d_in, padded_d_in(d_in), d_out,
                                     W.data_ptr(), B.data_ptr(), out.data_ptr(),
                                     torch.cuda.current_stream(x.device).cuda_stream)
    direction = "fwd" + ("_scenes" if lead else "")
    cuda_build.check(rc, "predictor_" + direction)
    if n and S:  # the C entry launches nothing for no rows
        _count(direction, d_in, d_out, S * n)
    return out


def bwd_buffers(n: int, di: int, dev, n_scenes: int = 1):
    """The backward's scratch (bf16: X, H and GZ of every layer, in 8 x 8
    pieces) and its per-chunk partials (f32), one torch.empty each, sized by
    the library; S scenes of n rows take S times one scene's."""
    lib = _lib()
    return (torch.empty(n_scenes * lib.predictor_scratch_elems(n, di), dtype=torch.bfloat16,
                        device=dev),
            torch.empty(n_scenes * lib.predictor_part_elems(n, di), device=dev))


def _bwd(x, W, B, gout, want_dx: bool = True):
    """One backward call (recompute and sweep, parameter pass, reduction), for
    one scene or S as `_fwd`: gout [..., n, d_out] -> (dx [..., n, d_in] or
    None, dW packed f32 [..., w], dB [..., 4, 256])."""
    lead, (n, d_in) = x.shape[:-2], x.shape[-2:]
    S = math.prod(lead)
    d_out, di = gout.shape[-1], padded_d_in(d_in)
    dev = x.device
    scratch, part = bwd_buffers(n, di, dev, S)
    dx = torch.empty(lead + (n, d_in), device=dev) if want_dx else None
    # no rows, no launch: the kernels write every element of dW and dB otherwise
    new = torch.empty if n else torch.zeros
    dW = new(W.shape, device=dev)
    dB = new(lead + (4, HID), device=dev)
    rc = _lib().predictor_bwd_scenes(x.data_ptr(), n, S, d_in, di, d_out, W.data_ptr(),
                                     B.data_ptr(), gout.data_ptr(),
                                     dx.data_ptr() if want_dx else None, int(want_dx),
                                     scratch.data_ptr(), part.data_ptr(), dW.data_ptr(),
                                     dB.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    direction = "bwd" + ("_scenes" if lead else "")
    cuda_build.check(rc, "predictor_" + direction)
    if n and S:
        _count(direction, d_in, d_out, S * n, want_dx)
    return dx, dW, dB


class _PredictorFn(torch.autograd.Function):
    @staticmethod
    @traced("nero.kernel.predictor.fwd")
    def forward(ctx, x, *wb):
        W, B = pack_weights(wb[:4], wb[4:])
        ctx.save_for_backward(x, W, B)
        ctx.d_out = wb[3].shape[1]
        return _fwd(x, W, B, ctx.d_out)

    @staticmethod
    @traced("nero.kernel.predictor.bwd")
    def backward(ctx, gout):
        x, W, B = ctx.saved_tensors
        d_in, d_out = x.shape[1], ctx.d_out
        dx, dW, dB = _bwd(x, W, B, gout.float().contiguous(), bool(ctx.needs_input_grad[0]))
        dws, dbs = unpack_grads(dW, dB, d_in, d_out)
        return (dx, *dws, *dbs)


def unpack_grads(dW: torch.Tensor, dB: torch.Tensor, d_in: int, d_out: int):
    """Kernel-layout gradients of one head -> (dw [in, out] x 4, db [out] x 4)."""
    shapes = _shapes(padded_d_in(d_in))
    g = [t.view(r, c) for t, (r, c) in zip(torch.split(dW, [r * c for r, c in shapes]), shapes)]
    return [g[0][:d_in], g[1], g[2], g[3][:, :d_out]], [dB[0], dB[1], dB[2], dB[3, :d_out]]


def pack_scenes(ws, bs):
    """4 stacked resolved weights [S, in, out] / biases [S, out] -> (packed
    bf16 [S, w], bias f32 [S, 4, 256]), each scene packed as one scene's is."""
    packs = [pack_weights([w[s] for w in ws], [b[s] for b in bs]) for s in range(ws[0].shape[0])]
    return (torch.stack([p[0] for p in packs]).contiguous(),
            torch.stack([p[1] for p in packs]).contiguous())


class _PredictorScenesFn(torch.autograd.Function):
    """_PredictorFn over S scenes: x [S, n, d_in], the weights and biases
    stacked [S, ...] -> [S, n, d_out]."""

    @staticmethod
    @traced("nero.kernel.predictor.fwd")
    def forward(ctx, x, *wb):
        W, B = pack_scenes(wb[:4], wb[4:])
        ctx.save_for_backward(x, W, B)
        ctx.d_out = wb[3].shape[-1]
        return _fwd(x, W, B, ctx.d_out)

    @staticmethod
    @traced("nero.kernel.predictor.bwd")
    def backward(ctx, gout):
        x, W, B = ctx.saved_tensors
        d_in, d_out = x.shape[-1], ctx.d_out
        dx, dW, dB = _bwd(x, W, B, gout.float().contiguous(), bool(ctx.needs_input_grad[0]))
        per_scene = [unpack_grads(dW[s], dB[s], d_in, d_out) for s in range(W.shape[0])]
        dws = [torch.stack(g) for g in zip(*[p[0] for p in per_scene])]
        dbs = [torch.stack(g) for g in zip(*[p[1] for p in per_scene])]
        return (dx, *dws, *dbs)


def predictor_scenes(layers, x: torch.Tensor, n_scenes: int) -> torch.Tensor:
    """`predictor` of S scenes: layers stacked on a leading scene axis ({v,g,b}
    or resolved {w,b}, [S, ...] each), x [..., d_in] with its rows
    scene-major (scene s's the s-th of S equal parts of the leading axis) ->
    [..., d_out], pre-activation. On a CUDA tensor one kernel launch each way
    for all scenes, no fallback; on a CPU tensor the plain version scene by
    scene."""
    if x.device.type == "cpu":
        return scene_map(predictor_plain, n_scenes, layers, x)
    resolved = resolve_weight_norm(layers)
    ws = [l["w"] for l in resolved]
    bs = [l["b"] for l in resolved]
    if not supported([w[0] for w in ws]):
        raise NotImplementedError(
            "the predictor kernel needs a 4-layer 256-wide head with d_in <= "
            f"{MAX_D_IN} and d_out <= {DO}; got {[tuple(w.shape[1:]) for w in ws]}")
    shape = x.shape[:-1]
    out = _PredictorScenesFn.apply(x.reshape(n_scenes, -1, x.shape[-1]).float().contiguous(),
                                   *ws, *bs)
    return out.reshape(*shape, out.shape[-1])


def predictor(layers, x: torch.Tensor) -> torch.Tensor:
    """[..., d_in] -> [..., d_out], pre-activation: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return predictor_plain(layers, x)
    resolved = resolve_weight_norm(layers)
    ws = [l["w"] for l in resolved]
    bs = [l["b"] for l in resolved]
    if not supported(ws):
        raise NotImplementedError(
            "the predictor kernel needs a 4-layer 256-wide head with d_in <= "
            f"{MAX_D_IN} and d_out <= {DO}; got {[tuple(w.shape) for w in ws]}")
    shape = x.shape[:-1]
    out = _PredictorFn.apply(x.reshape(-1, x.shape[-1]).float().contiguous(), *ws, *bs)
    return out.reshape(*shape, out.shape[-1])


# ---------------------------------------------------------------------------
# the least work the function needs (for the bound beside the kernel time)
# ---------------------------------------------------------------------------


def bwd_flops_per_row(d_in: int, d_out: int, want_dx: bool = True) -> float:
    """What the backward needs: the recompute of the hidden layers (the
    output layer's value is not needed: its cotangent GZ4 is the input
    cotangent), dW = X^T GZ of every layer, and GH = GZ W^T down to the
    input, its last product only when dx is wanted."""
    recompute = d_in * HID + 2 * HID * HID
    dw = d_in * HID + 2 * HID * HID + HID * d_out
    dx = HID * d_out + 2 * HID * HID + (d_in * HID if want_dx else 0)
    return 2.0 * (recompute + dw + dx)


def flops(n: int, d_in: int, d_out: int, backward: bool = False,
          want_dx: bool = True) -> float:
    """The forward's products, or the backward's (`bwd_flops_per_row`)."""
    if backward:
        return n * bwd_flops_per_row(d_in, d_out, want_dx)
    return 2.0 * n * (d_in * HID + 2 * HID * HID + HID * d_out)


def min_bytes(n: int, d_in: int, d_out: int, backward: bool = False) -> float:
    w = d_in * HID + 2 * HID * HID + HID * d_out
    if backward:
        return n * (d_in + d_out) * 4 + n * d_in * 4 + w * 2 + w * 4
    return n * (d_in + d_out) * 4 + w * 2
