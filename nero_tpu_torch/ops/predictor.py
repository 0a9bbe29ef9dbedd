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
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from nero_tpu_torch.ops import cuda_build
from nero_tpu_torch.ops.mlp import predictor_raw, resolve_weight_norm

TILE = 64
HID = 256
DO = 16          # outputs padded (csrc/predictor.cu DO)
MAX_D_IN = 272   # csrc/predictor.cu MAX_DI

# launches per head shape "<d_in>x<d_out>"; the Stage-I shader's shapes are
# listed up front so that a reader of the counters sees them at 0
SHADER_SHAPES = ((259, 1), (259, 3), (72, 3), (144, 3), (123, 3), (90, 1), (24, 4))
launches = {f"predictor_{d}_{di}x{do}": 0 for di, do in SHADER_SHAPES for d in ("fwd", "bwd")}


def _count(direction: str, d_in: int, d_out: int) -> None:
    key = f"predictor_{direction}_{d_in}x{d_out}"
    launches[key] = launches.get(key, 0) + 1


def predictor_plain(layers, x: torch.Tensor) -> torch.Tensor:
    """[..., d_in] -> [..., d_out], pre-activation, in plain torch."""
    return predictor_raw(layers, x)


def supported(ws) -> bool:
    return (len(ws) == 4 and ws[0].shape[1] == HID and ws[1].shape == (HID, HID)
            and ws[2].shape == (HID, HID) and ws[3].shape[0] == HID
            and ws[0].shape[0] <= MAX_D_IN and ws[3].shape[1] <= DO)


def padded_d_in(d_in: int) -> int:
    return -(-d_in // 16) * 16


def _lib():
    lib = cuda_build.load("predictor")
    if not getattr(lib, "_nero_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        for name in ("predictor_tile", "predictor_max_d_in", "predictor_max_d_out"):
            getattr(lib, name).restype = i
            getattr(lib, name).argtypes = []
        lib.predictor_weight_elems.restype = ctypes.c_size_t
        lib.predictor_weight_elems.argtypes = [i]
        lib.predictor_scratch_elems.restype = ctypes.c_size_t
        lib.predictor_scratch_elems.argtypes = [i, i]
        lib.predictor_part_elems.restype = ctypes.c_size_t
        lib.predictor_part_elems.argtypes = [i]
        lib.predictor_fwd.restype = i
        lib.predictor_fwd.argtypes = [vp, i, i, i, i, vp, vp, vp, vp]
        lib.predictor_bwd.restype = i
        lib.predictor_bwd.argtypes = [vp, i, i, i, i, vp, vp, vp, vp, i, vp, vp, vp, vp, vp]
        if (lib.predictor_tile() != TILE or lib.predictor_max_d_in() != MAX_D_IN
                or lib.predictor_max_d_out() != DO):
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
    """One forward launch on packed weights: x [n, d_in] -> [n, d_out]."""
    n, d_in = x.shape
    out = torch.empty(n, d_out, device=x.device)
    rc = _lib().predictor_fwd(x.data_ptr(), n, d_in, padded_d_in(d_in), d_out, W.data_ptr(),
                              B.data_ptr(), out.data_ptr(),
                              torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(rc, "predictor_fwd")
    _count("fwd", d_in, d_out)
    return out


def _bwd(x, W, B, gout, want_dx: bool = True):
    """One backward launch (rows kernel + the gradient reductions): gout
    [n, d_out] -> (dx [n, d_in] or None, dW packed f32, dB [4, 256])."""
    n, d_in = x.shape
    d_out, di = gout.shape[1], padded_d_in(d_in)
    dev = x.device
    lib = _lib()
    m_rows = -(-n // TILE) * TILE
    scratch = torch.empty(lib.predictor_scratch_elems(m_rows, di), dtype=torch.bfloat16,
                          device=dev)
    part = torch.empty(lib.predictor_part_elems(m_rows), device=dev)
    dx = torch.empty(n, d_in, device=dev) if want_dx else None
    # no rows, no launch: the kernel would leave dW unwritten
    dW = torch.empty(W.numel(), device=dev) if n else torch.zeros(W.numel(), device=dev)
    dB = torch.zeros(4, HID, device=dev)
    rc = lib.predictor_bwd(x.data_ptr(), n, d_in, di, d_out, W.data_ptr(), B.data_ptr(),
                           gout.data_ptr(), dx.data_ptr() if want_dx else None, int(want_dx),
                           scratch.data_ptr(), part.data_ptr(), dW.data_ptr(), dB.data_ptr(),
                           torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "predictor_bwd")
    _count("bwd", d_in, d_out)
    return dx, dW, dB


class _PredictorFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *wb):
        W, B = pack_weights(wb[:4], wb[4:])
        ctx.save_for_backward(x, W, B)
        ctx.d_out = wb[3].shape[1]
        return _fwd(x, W, B, ctx.d_out)

    @staticmethod
    def backward(ctx, gout):
        x, W, B = ctx.saved_tensors
        d_in, d_out = x.shape[1], ctx.d_out
        dx, dW, dB = _bwd(x, W, B, gout.float().contiguous(), bool(ctx.needs_input_grad[0]))
        shapes = _shapes(padded_d_in(d_in))
        g = [t.view(r, c) for t, (r, c) in zip(torch.split(dW, [r * c for r, c in shapes]),
                                                shapes)]
        dws = [g[0][:d_in], g[1], g[2], g[3][:, :d_out]]
        dbs = [dB[0], dB[1], dB[2], dB[3, :d_out]]
        return (dx, *dws, *dbs)


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


def flops(n: int, d_in: int, d_out: int, backward: bool = False) -> float:
    """Forward; the backward recomputes it, then the input-cotangent and
    weight-gradient products (3x)."""
    kn = d_in * HID + 2 * HID * HID + HID * d_out
    return 2.0 * n * kn * (3 if backward else 1)


def min_bytes(n: int, d_in: int, d_out: int, backward: bool = False) -> float:
    w = d_in * HID + 2 * HID * HID + HID * d_out
    if backward:
        return n * (d_in + d_out) * 4 + n * d_in * 4 + w * 2 + w * 4
    return n * (d_in + d_out) * 4 + w * 2
