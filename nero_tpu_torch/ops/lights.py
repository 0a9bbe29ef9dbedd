"""Stage-II light heads with their IDE / PE encodings: CUDA kernel (forward
and backward) and its plain version.

Replaces nero_tpu/ops/pallas/light_kernel.py::lights_fused_raw (:307), whose
pallas_calls are nero_lights_fwd_f* (:231) and nero_lights_bwd_f* (:259). The
kernel source is csrc/lights.cu; its header comment gives the design,
including the hand-derived backward that replaces the in-kernel jax.vjp.
`lights_raw` launches the kernel for CUDA tensors and runs `lights_raw_plain`
(plain torch, autograd) for CPU tensors, and only then. Both return the
pre-exp outputs (inner_z, outer_z) of the inner and outer light heads on
every row of the (surface point x sample direction) lattice; the exp
activations, the hit select and the human light stay outside
(fields/mc_shading.py::get_lights). mode 'outer' evaluates the outer head
only (inner_z is zeros): the regime where the inner head runs hit-compacted.

Both follow the unfused light path (`predict_outer_lights`,
`get_inner_lights`) in value and in gradient. In particular the
`sphere_direction` variant encodes the ray's hit point on the unit sphere as
it is, where the TPU kernel normalises it first (light_kernel.py:93): the
forward is the same to 5e-7, the gradients to points and directions are not.
Gradients flow to the heads' parameters, the points and the directions; the
traced hit points and normals get none (they come from the tracer detached).

The kernel takes every IDE degree nero_tpu's kernel takes (up to 5,
`supported`); the degree is the library's (one build per degree,
`defines`), and the launch counters of a degree other than the shipped 5
carry the suffix `_d<ide_deg>`. The inner head's PE stays at 8 octaves on
both sides.

What bounds it on the card: tensor-core operations (`flops`): at 393,216
rows and 989 TFLOP/s about 0.25 ms forward and 0.74 ms backward in mode
'both'; the bytes it must move (48 in and 24 out per row) take 0.008 ms.
The forward is one launch on the backward's engine (128-row tiles, the
weights streamed from L2 as slabs through a cp.async ring, mma.sync); its
phases run one after another, and the weight stream is the largest (about
55% of its time on the H100, the input encodings 25%, the products 20%).
The backward is three launches (recompute and reverse sweep, the weight-
and bias-gradient pass, the reduction of its partials) through a scratch of
X, H and GZ in device memory: 6.6 KB a row in mode 'both', 2.6 GB at
393,216 rows (`bwd_buffers`).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from nero_tpu_torch.ops import cuda_build
from nero_tpu_torch.ops.mlp import predictor_raw, resolve_weight_norm
from nero_tpu_torch.ops.shader import ide_table_on
from nero_tpu_torch.utils.encodings import (ide_dim, integrated_dir_encode, positional_encode,
                                            positional_encode_dim)
from nero_tpu_torch.utils.sphere import get_sphere_intersection

TILE = 128      # rows per block, forward and backward (csrc/lights.cu PB)
HID = 256
DO = 16
GEO = 12   # points, directions, traced hit points, hit normals
OUT = 6    # inner_z 0:3, outer_z 3:6
HEAD_ORDER = ("inner_light", "outer_light")
INNER_POS_FREQ = 8
IDE_DEG = 5                      # the shipped degree: the library built without defines
MAX_IDE_DEG = 5


def di_pad(ide_deg: int = IDE_DEG) -> dict:
    """Padded input widths (csrc/lights.cu DI_INNER, DI_OUTER, DI_OUTER_SPH)."""
    sph = ide_dim(ide_deg)
    pad = lambda d: -(-d // 16) * 16
    return {"inner_light": pad(positional_encode_dim(3, INNER_POS_FREQ) + sph),
            "outer_light": pad(sph), "outer_light_sphere": pad(2 * sph)}


DI_PAD = di_pad()


def defines(ide_deg: int) -> tuple:
    """The build's -D macros: none at the shipped degree."""
    return () if ide_deg == IDE_DEG else (("NERO_IDE_DEG", ide_deg),)


def counter(name: str, ide_deg: int) -> str:
    return name if ide_deg == IDE_DEG else f"{name}_d{ide_deg}"


# counted per mode: "both" under the plain names, "outer" with the suffix;
# per degree: another degree's, `_d<ide_deg>` after them, added at its first launch
launches = {"lights_fwd": 0, "lights_bwd": 0, "lights_fwd_outer": 0, "lights_bwd_outer": 0}
# FLOPs of every counted launch, by `flops(...)` at the launch's shapes (core/mfu.py)
flop_tally = dict.fromkeys(launches, 0.0)


def _count(name: str, ide_deg: int, flop: float) -> None:
    key = counter(name, ide_deg)
    launches[key] = launches.get(key, 0) + 1
    flop_tally[key] = flop_tally.get(key, 0.0) + flop


class _Variant(NamedTuple):
    ide_deg: int
    outer_light_version: str


def variant_cfg(sphere: bool, ide_deg: int = IDE_DEG) -> _Variant:
    """What `head_dims` reads of a config, for a kernel variant."""
    return _Variant(ide_deg, "sphere_direction" if sphere else "direction")


def supported(cfg) -> bool:
    """Configurations the kernel takes, nero_tpu's rule (fields/
    mc_shading.py:129: ide_deg <= 5; the outer compaction is the resolver's,
    fields/mc_shading.py::fused_lights_active). The plain version takes any."""
    return cfg.ide_deg <= MAX_IDE_DEG


def head_dims(cfg, mode: str = "both") -> dict:
    """Unpadded (d_in, d_out) per evaluated head, in HEAD_ORDER."""
    sph = ide_dim(cfg.ide_deg)
    dims = {}
    if mode == "both":
        dims["inner_light"] = (positional_encode_dim(3, INNER_POS_FREQ) + sph, 3)
    dims["outer_light"] = (sph * (2 if cfg.outer_light_version == "sphere_direction" else 1), 3)
    return dims


def _check_mode(mode: str) -> None:
    if mode not in ("both", "outer"):
        raise ValueError(f"mode {mode!r}")


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def outer_light_input(cfg, points, directions) -> torch.Tensor:
    """The outer light head's input: IDE(direction) at kappa = 0, the
    direction taken as it is (unit by construction); for `sphere_direction`
    also IDE of the ray's hit point on the unit sphere, not normalised."""
    enc = integrated_dir_encode(directions, 0.0, cfg.ide_deg)
    if cfg.outer_light_version == "direction":
        return enc
    if cfg.outer_light_version == "sphere_direction":
        norm = torch.linalg.norm(points, dim=-1, keepdim=True)
        pts = torch.where(norm > 0.999, points * 0.999 / torch.clamp(norm, min=1e-12), points)
        sphere_pts = pts + directions * get_sphere_intersection(pts, directions)
        return torch.cat([enc, integrated_dir_encode(sphere_pts, 0.0, cfg.ide_deg)], -1)
    raise NotImplementedError(cfg.outer_light_version)


def inner_light_input(cfg, points, view_dirs, normals) -> torch.Tensor:
    """The inner light head's input: PE8(hit point) and IDE at kappa = 0 of
    the reflection of the normalised view direction about the normalised
    normal."""
    normals = _normalize(normals)
    view_dirs = _normalize(view_dirs)
    refl = torch.sum(view_dirs * normals, -1, keepdim=True) * normals * 2 - view_dirs
    return torch.cat([positional_encode(points, INNER_POS_FREQ),
                      integrated_dir_encode(refl, 0.0, cfg.ide_deg)], -1)


def lights_raw_plain(params, cfg, points, directions, inters, normals, mode: str = "both"):
    """(inner_z, outer_z), each [..., 3], in plain torch: the unfused light
    path (the two functions above are its encodings) without the final exp."""
    _check_mode(mode)
    outer_z = predictor_raw(params["outer_light"], outer_light_input(cfg, points, directions))
    if mode == "outer":
        return torch.zeros_like(outer_z), outer_z
    inner_in = inner_light_input(cfg, inters.detach(), -directions, normals.detach())
    return predictor_raw(params["inner_light"], inner_in), outer_z


# ---------------------------------------------------------------------------
# kernel plumbing
# ---------------------------------------------------------------------------


def _pad_of(name: str, sphere: bool, ide_deg: int = IDE_DEG) -> int:
    return di_pad(ide_deg)["outer_light_sphere" if name == "outer_light" and sphere else name]


def _head_shapes(name: str, sphere: bool, ide_deg: int = IDE_DEG):
    return ((_pad_of(name, sphere, ide_deg), HID), (HID, HID), (HID, HID), (HID, DO))


def _heads(both: bool):
    return HEAD_ORDER if both else HEAD_ORDER[1:]


def weight_elems(sphere: bool, both: bool, ide_deg: int = IDE_DEG) -> int:
    return sum(r * c for n in _heads(both) for r, c in _head_shapes(n, sphere, ide_deg))


def type_lib(lib) -> bool:
    """Give the library's C entries their ctypes signatures; returns whether
    it has the backward's two parts (`lights_bwd_sweep`, `lights_bwd_params`).
    An earlier source sizes its buffers by (m_rows, sphere, both) and
    (m_rows): the extra arguments are ignored there."""
    vp, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.lights_tile.restype, lib.lights_tile.argtypes = i, []
    lib.lights_weight_elems.restype, lib.lights_weight_elems.argtypes = sz, [i, i]
    for fn in ("lights_scratch_elems", "lights_part_elems"):
        getattr(lib, fn).restype, getattr(lib, fn).argtypes = sz, [i, i, i]
    lib.lights_fwd.restype = i
    lib.lights_fwd.argtypes = [vp, i, vp, vp, vp, i, i, vp, vp]
    lib.lights_bwd.restype = i
    lib.lights_bwd.argtypes = [vp, i, vp, vp, vp, i, i, vp, vp, vp, vp, vp, vp, vp]
    parts = hasattr(lib, "lights_bwd_sweep")
    if parts:
        lib.lights_bwd_sweep.restype = i
        lib.lights_bwd_sweep.argtypes = [vp, i, vp, vp, vp, i, i, vp, vp, vp, vp]
        lib.lights_bwd_params.restype = i
        lib.lights_bwd_params.argtypes = [i, i, i, vp, vp, vp, vp, vp]
    return parts


def _lib(ide_deg: int = IDE_DEG):
    lib = cuda_build.load("lights", defines(ide_deg))
    if not getattr(lib, "_nero_typed", False):
        if not type_lib(lib):
            raise RuntimeError("csrc/lights.cu has no lights_bwd_sweep / lights_bwd_params")
        if lib.lights_tile() != TILE or any(
                lib.lights_weight_elems(int(s), int(b)) != weight_elems(s, b, ide_deg)
                for s in (False, True) for b in (False, True)):
            raise RuntimeError("csrc/lights.cu layout differs from ops/lights.py")
        lib._nero_typed = True
    return lib


def pack_light_params(params, cfg, mode: str = "both"):
    """Light head dicts -> (ws, bs): the resolved weights and biases, 4 per
    evaluated head in HEAD_ORDER, differentiable back to the weight-norm
    leaves (v, g, b)."""
    _check_mode(mode)
    dims = head_dims(cfg, mode)
    ws, bs = [], []
    for name, (d_in, d_out) in dims.items():
        layers = resolve_weight_norm(params[name])
        shape = (tuple(layers[0]["w"].shape), tuple(layers[3]["w"].shape))
        if shape != ((d_in, HID), (HID, d_out)) or len(layers) != 4:
            raise ValueError(f"{name}: layer shapes {shape}, expected a 4-layer head "
                             f"{d_in} -> {HID} -> {d_out}")
        ws += [l["w"] for l in layers]
        bs += [l["b"] for l in layers]
    return ws, bs


def pack_buffers(ws, bs, sphere: bool, both: bool, ide_deg: int = IDE_DEG):
    """Resolved weights / biases -> (packed bf16 weights, bias f32
    [heads, 4, 256]) in the kernel layout (zero padding)."""
    names = _heads(both)
    parts = []
    bias = torch.zeros(len(names), 4, HID, dtype=torch.float32, device=ws[0].device)
    for h, name in enumerate(names):
        for l, (r, c) in enumerate(_head_shapes(name, sphere, ide_deg)):
            w, b = ws[4 * h + l], bs[4 * h + l]
            parts.append(F.pad(w, (0, c - w.shape[1], 0, r - w.shape[0])).reshape(-1))
            bias[h, l, :b.shape[0]] = b
    return torch.cat(parts).to(torch.bfloat16).contiguous(), bias


def unpack_grads(dW: torch.Tensor, dB: torch.Tensor, shapes, sphere: bool, both: bool,
                 ide_deg: int = IDE_DEG):
    """Packed gradients -> per-tensor gradients of the weights' `shapes` and
    of their biases."""
    names = _heads(both)
    sizes = [r * c for n in names for r, c in _head_shapes(n, sphere, ide_deg)]
    chunks = torch.split(dW, sizes)
    dws, dbs = [], []
    for h, name in enumerate(names):
        for l, (r, c) in enumerate(_head_shapes(name, sphere, ide_deg)):
            rows, cols = shapes[4 * h + l]
            dws.append(chunks[4 * h + l].view(r, c)[:rows, :cols])
            dbs.append(dB[h, l, :cols])
    return dws, dbs


def _fwd(geo, W, B, sphere: bool, both: bool, ide_deg: int = IDE_DEG) -> torch.Tensor:
    """One forward launch on packed weights: geo [n, 12] -> raw [n, 6]. No
    rows: an empty output, no launch."""
    n = geo.shape[0]
    out = torch.empty(n, OUT, device=geo.device)
    if n == 0:
        return out
    rc = _lib(ide_deg).lights_fwd(geo.data_ptr(), n, W.data_ptr(), B.data_ptr(),
                                  ide_table_on(geo.device, ide_deg).data_ptr(), int(sphere),
                                  int(both), out.data_ptr(),
                                  torch.cuda.current_stream(geo.device).cuda_stream)
    cuda_build.check(rc, "lights_fwd")
    _count("lights_fwd" if both else "lights_fwd_outer", ide_deg,
           flops(n, variant_cfg(sphere, ide_deg), "both" if both else "outer"))
    return out


def bwd_buffers(n: int, sphere: bool, both: bool, dev, ide_deg: int = IDE_DEG):
    """The backward's scratch (bf16: X, H and GZ of every layer of every
    evaluated head, in 8 x 8 pieces) and its per-chunk partials (f32), one
    torch.empty each, sized by the library."""
    lib = _lib(ide_deg)
    return (torch.empty(lib.lights_scratch_elems(n, int(sphere), int(both)),
                        dtype=torch.bfloat16, device=dev),
            torch.empty(lib.lights_part_elems(n, int(sphere), int(both)), device=dev))


def _bwd(geo, W, B, sphere: bool, both: bool, gout, ide_deg: int = IDE_DEG):
    """One backward call (recompute and sweep, parameter pass, reduction):
    gout [n, 6] -> (d points and d directions [n, 6], dW packed f32, dB)."""
    n = geo.shape[0]
    dev = geo.device
    lib = _lib(ide_deg)
    scratch, part = bwd_buffers(n, sphere, both, dev, ide_deg)
    dgeo6 = torch.empty(n, 6, device=dev)
    # no rows, no launch: the kernels write every element of dW and dB otherwise
    new = torch.empty if n else torch.zeros
    dW = new(W.numel(), device=dev)
    dB = new(B.shape, device=dev)
    rc = lib.lights_bwd(geo.data_ptr(), n, W.data_ptr(), B.data_ptr(),
                        ide_table_on(dev, ide_deg).data_ptr(), int(sphere), int(both),
                        gout.data_ptr(), dgeo6.data_ptr(), scratch.data_ptr(), part.data_ptr(),
                        dW.data_ptr(), dB.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "lights_bwd")
    if n:
        _count("lights_bwd" if both else "lights_bwd_outer", ide_deg,
               flops(n, variant_cfg(sphere, ide_deg), "both" if both else "outer",
                     backward=True))
    return dgeo6, dW, dB


class _LightsFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, geo, sphere, both, ide_deg, *wb):
        k = len(wb) // 2
        W, B = pack_buffers(wb[:k], wb[k:], sphere, both, ide_deg)
        out = _fwd(geo, W, B, sphere, both, ide_deg)
        ctx.save_for_backward(geo, W, B)
        ctx.meta = (sphere, both, ide_deg, [tuple(w.shape) for w in wb[:k]])
        return out

    @staticmethod
    def backward(ctx, gout):
        geo, W, B = ctx.saved_tensors
        sphere, both, ide_deg, shapes = ctx.meta
        dgeo6, dW, dB = _bwd(geo, W, B, sphere, both, gout.float().contiguous(), ide_deg)
        # the traced hit points and normals (columns 6:12) get no gradient
        dgeo = F.pad(dgeo6, (0, GEO - 6))
        dws, dbs = unpack_grads(dW, dB, shapes, sphere, both, ide_deg)
        return (dgeo, None, None, None, *dws, *dbs)


def kernel_inputs(params, cfg, points, directions, inters, normals, mode: str = "both"):
    """What the kernel reads, from the light heads' arguments: (geo [n, 12],
    sphere, both, resolved weights, biases)."""
    n = int(np.prod(points.shape[:-1]))
    both = mode == "both"
    sphere = cfg.outer_light_version == "sphere_direction"
    rs = lambda a: a.reshape(n, 3)
    hit_geo = ((rs(inters).detach(), rs(normals).detach()) if both
               else (points.new_zeros(n, 6),))
    geo = torch.cat([rs(points), rs(directions), *hit_geo], -1).float().contiguous()
    ws, bs = pack_light_params(params, cfg, mode)
    return geo, sphere, both, ws, bs


def lights_raw(params, cfg, points, directions, inters, normals, mode: str = "both"):
    """Raw (pre-exp) light head outputs (inner_z, outer_z), each [..., 3]:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    Gradients flow to the heads' parameters, the points and the directions."""
    if points.device.type == "cpu":
        return lights_raw_plain(params, cfg, points, directions, inters, normals, mode)
    _check_mode(mode)
    if not supported(cfg):
        raise NotImplementedError(f"the light kernel takes ide_deg <= {MAX_IDE_DEG}, got "
                                  f"{cfg.ide_deg}")
    shape = points.shape[:-1]
    geo, sphere, both, ws, bs = kernel_inputs(params, cfg, points, directions, inters, normals,
                                              mode)
    out = _LightsFn.apply(geo, sphere, both, cfg.ide_deg, *ws, *bs)
    return out[:, 0:3].reshape(*shape, 3), out[:, 3:6].reshape(*shape, 3)


# ---------------------------------------------------------------------------
# the least work the function needs (for the bound beside the kernel time)
# ---------------------------------------------------------------------------


def flops_per_row(cfg, mode: str = "both") -> float:
    """Head products at their true widths."""
    return 2.0 * sum(d_in * HID + 2 * HID * HID + HID * d_out
                     for d_in, d_out in head_dims(cfg, mode).values())


def bwd_flops_per_row(cfg, mode: str = "both") -> float:
    """What the backward needs: the recompute of the hidden layers (the
    output layer's value is not needed), dW = X^T GZ of every layer, and
    GH = GZ W^T down to the input columns that carry a gradient. The inner
    head's PE8 of the traced hit point carries none (the hit point is
    detached), so its dX is over the IDE columns alone."""
    sph = ide_dim(cfg.ide_deg)
    total = 0.0
    for name, (d_in, d_out) in head_dims(cfg, mode).items():
        dx_in = sph if name == "inner_light" else d_in
        recompute = d_in * HID + 2 * HID * HID
        dw = d_in * HID + 2 * HID * HID + HID * d_out
        dx = HID * d_out + 2 * HID * HID + HID * dx_in
        total += 2.0 * (recompute + dw + dx)
    return total


def flops(n: int, cfg, mode: str = "both", backward: bool = False) -> float:
    """The forward's products, or the backward's (`bwd_flops_per_row`)."""
    return n * (bwd_flops_per_row(cfg, mode) if backward else flops_per_row(cfg, mode))


def min_bytes(n: int, cfg, mode: str = "both", backward: bool = False) -> float:
    """Forward: geometry in (6 or 12 f32 per row), 6 f32 out, bf16 weights.
    Backward: geometry and the cotangent in, d points and d directions out,
    weights in and f32 weight gradients out."""
    both = mode == "both"
    w = weight_elems(cfg.outer_light_version == "sphere_direction", both, cfg.ide_deg)
    geo = 12 if both else 6
    if backward:
        return n * (geo + OUT + 6) * 4 + w * 2 + w * 4
    return n * (geo + OUT) * 4 + w * 2
