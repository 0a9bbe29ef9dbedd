"""One evaluation of the distilled field per point: the CUDA kernel and its
plain version.

Replaces nero_tpu/ops/pallas/field_kernel.py::field_fwd_fused (:119, its
pallas_call at :90). The kernel source is csrc/field_fwd.cu. `field_fwd`
launches the kernel for CUDA tensors and runs `field_fwd_plain` for CPU
tensors, and only then; both round the operands of the products to bf16 and
sum in f32. There is no gradient: the differentiable f32 field is
geometry/neural_tracer.py::field_apply. As in the JAX package, no training
path calls it (the tracers march inside their own kernels); it is the field
of the march kernels evaluated once, for tests and checks of a distilled
field. The packed field and the kernel buffers are those of
ops/sphere_march.py.

What bounds it on the card: tensor-core operations (`flops`), one field
evaluation per point against 16 bytes per point.
"""
from __future__ import annotations

import ctypes

import torch

from nero_tpu_torch.core.trace import span
from nero_tpu_torch.ops import cuda_build
from nero_tpu_torch.ops.sphere_march import (PE, buffer_elems, check_packed, eval_flops,
                                             field_eval_plain, field_lib, kernel_buffers, prep)

launches = {"field_fwd": 0, "field_fwd_wide": 0}
# FLOPs of every counted launch, by `flops(...)` at the launch's shapes (core/mfu.py)
flop_tally = dict.fromkeys(launches, 0.0)


@torch.no_grad()
def field_fwd_plain(packed, pts: torch.Tensor, pe: int = PE) -> torch.Tensor:
    """[..., 3] -> [...]: the packed field, bf16 operands and f32 sums."""
    return field_eval_plain(packed, pts.reshape(-1, 3), pe).reshape(pts.shape[:-1])


def _lib():
    vp, i = ctypes.c_void_p, ctypes.c_int
    return field_lib("field_fwd", [vp, i, vp, vp, i, i, vp, vp])


def _launch(W, Fv, wide, pts, pe: int = PE):
    n = pts.shape[0]
    out = torch.empty(n, device=pts.device)
    if n == 0:  # nothing to launch, nothing counted
        return out
    rc = _lib().field_fwd(pts.data_ptr(), n, W.data_ptr(), Fv.data_ptr(), int(wide), pe,
                          out.data_ptr(), torch.cuda.current_stream(pts.device).cuda_stream)
    cuda_build.check(rc, "field_fwd")
    launches["field_fwd_wide" if wide else "field_fwd"] += 1
    flop_tally["field_fwd_wide" if wide else "field_fwd"] += flops(n, "wide" if wide else "std",
                                                                   pe)
    return out


@torch.no_grad()
def field_fwd(packed, pts: torch.Tensor, pe: int = PE, topology: str = "std") -> torch.Tensor:
    """[..., 3] -> [...], detached: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    check_packed(packed, topology, pe, kernel=pts.device.type != "cpu")
    if pts.device.type == "cpu":
        return field_fwd_plain(packed, pts, pe)
    with span("nero.kernel.field_fwd.fwd"):
        W, Fv = kernel_buffers(packed)
        return _launch(W, Fv, topology == "wide", prep(pts.reshape(-1, 3)),
                       pe).reshape(pts.shape[:-1])


def flops(n: int, topology: str = "std", pe: int = PE) -> float:
    return float(n) * eval_flops(topology, pe)


def min_bytes(n: int, topology: str = "std") -> float:
    """Points read once (3 f32), values written once, and the bf16 weights."""
    return n * 4 * 4 + buffer_elems(topology == "wide")[0] * 2
