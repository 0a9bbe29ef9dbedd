"""Uniform-march visibility tracing of the distilled field: the CUDA kernel
and its plain version.

Replaces nero_tpu/ops/pallas/march_kernel.py::march_fused (:407, its
pallas_call at :190, body `_march_kernel` :135-176). The kernel source is
csrc/march.cu; its header comment gives the design. `march` launches the
kernel for CUDA tensors and runs `march_plain` for CPU tensors, and only
then. Both compute, per ray, the field at `n_coarse` uniform samples of
[t_enter, t_exit], take the first sample pair that goes from > 0 to <= 0 as
the bracket, bisect it `n_refine` times and return its midpoint; operands of
the field's products are rounded to bf16 and summed in f32, so the two differ
in summation order only. `found` does not include bounding-sphere validity:
the caller masks. There is no gradient. The packed field, its plain
evaluation and the kernel buffers are those of ops/sphere_march.py.

What bounds it on the card: tensor-core operations (`flops`): every ray
takes n_coarse + n_refine field evaluations, against 40 bytes per ray.
"""
from __future__ import annotations

import ctypes

import torch

from nero_tpu_torch.core.trace import span
from nero_tpu_torch.ops import cuda_build
from nero_tpu_torch.ops.sphere_march import (PE, check_packed, eval_flops, field_eval_plain,
                                             field_lib, kernel_buffers, prep)

launches = {"march": 0, "march_wide": 0}
# FLOPs of every counted launch, by `flops(...)` at the launch's shapes (core/mfu.py)
flop_tally = dict.fromkeys(launches, 0.0)


@torch.no_grad()
def march_plain(packed, rays_o, rays_d, t_enter, t_exit, *, pe: int = PE, n_coarse: int = 48,
                n_refine: int = 8, t0: float = 0.012):
    """Step-by-step transcription of `_march_kernel`, one batched field
    evaluation per trip; the topology is the packed field's. Returns
    (t_hit [R] f32, found [R] bool)."""
    def field(t):
        return field_eval_plain(packed, rays_o + rays_d * t[:, None], pe)

    dt = (t_exit - t_enter) / (n_coarse - 1)
    prev_v = field(t_enter)
    found = (prev_v <= 0.0) & (t_enter <= t0 + 1e-6)   # the ray starts inside
    t_lo, t_hi = t_enter, t_enter
    for i in range(1, n_coarse):
        t_i = t_enter + dt * float(i)
        v = field(t_i)
        change = (prev_v > 0.0) & (v <= 0.0) & ~found
        t_lo = torch.where(change, t_i - dt, t_lo)
        t_hi = torch.where(change, t_i, t_hi)
        found = found | change
        prev_v = v
    for _ in range(n_refine):
        mid = 0.5 * (t_lo + t_hi)
        pos = field(mid) > 0.0
        t_lo, t_hi = torch.where(pos, mid, t_lo), torch.where(pos, t_hi, mid)
    return 0.5 * (t_lo + t_hi), found


def _lib():
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return field_lib("march", [vp, vp, vp, vp, i, vp, vp, i, i, i, i, f, vp, vp, vp])


def _launch(W, Fv, wide, rays_o, rays_d, t_enter, t_exit, n_coarse, n_refine, t0_eps,
            pe: int = PE):
    r = rays_o.shape[0]
    dev = rays_o.device
    t_out = torch.empty(r, device=dev)
    found = torch.empty(r, dtype=torch.bool, device=dev)
    if r == 0:  # nothing to launch, nothing counted
        return t_out, found
    rc = _lib().march(rays_o.data_ptr(), rays_d.data_ptr(), t_enter.data_ptr(),
                      t_exit.data_ptr(), r, W.data_ptr(), Fv.data_ptr(), int(wide), pe,
                      n_coarse, n_refine, t0_eps, t_out.data_ptr(), found.data_ptr(),
                      torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "march")
    launches["march_wide" if wide else "march"] += 1
    flop_tally["march_wide" if wide else "march"] += flops(r, n_coarse, n_refine,
                                                           "wide" if wide else "std", pe)
    return t_out, found


@torch.no_grad()
def march(packed, rays_o, rays_d, t_enter, t_exit, *, pe: int = PE, n_coarse: int = 48,
          n_refine: int = 8, t0: float = 0.012, topology: str = "std"):
    """Uniform march of [R] rays -> (t_hit [R], found [R] bool), both
    detached: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    check_packed(packed, topology, pe, kernel=rays_o.device.type != "cpu")
    if n_coarse < 2:
        raise ValueError(f"n_coarse = {n_coarse}: the scan needs two samples at least")
    if rays_o.device.type == "cpu":
        return march_plain(packed, rays_o, rays_d, t_enter, t_exit, pe=pe, n_coarse=n_coarse,
                           n_refine=n_refine, t0=t0)
    with span("nero.kernel.march.fwd"):
        W, Fv = kernel_buffers(packed)
        return _launch(W, Fv, topology == "wide", prep(rays_o), prep(rays_d), prep(t_enter),
                       prep(t_exit), n_coarse, n_refine, float(t0 + 1e-6), pe)


def flops(r: int, n_coarse: int, n_refine: int, topology: str = "std", pe: int = PE) -> float:
    """Every ray runs every trip: r x (n_coarse + n_refine) evaluations."""
    return float(r) * (n_coarse + n_refine) * eval_flops(topology, pe)

