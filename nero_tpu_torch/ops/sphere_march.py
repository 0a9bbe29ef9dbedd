"""Sphere-march visibility tracing of the distilled field: the CUDA kernel
and its plain version, and the packed field they share with ops/march.py and
ops/field_fwd.py.

Replaces nero_tpu/ops/pallas/march_kernel.py::sphere_march_fused (:358, its
pallas_call at :338) and keeps nero_tpu/ops/pallas/field_kernel.py's
`pack_field_params` layout (:26-52) for both field topologies. The kernel
source is csrc/sphere_march.cu, on csrc/field.cuh's warp-tile engine (which
the uniform march and the field forward share): warp-private tiles of 16
rays on mma.sync with the weights resident in shared memory and the
activations in registers; the two files' header comments give the design. `sphere_march` launches the kernel for CUDA
tensors and runs `sphere_march_plain` for CPU tensors, and only then. Both
compute, per ray, `n_sphere` sphere-trace evaluations of the field (`std`:
a PE of `pe` octaves, 0-7 (6 unless given), -> 3 x 128 ReLU -> 1, as
nero_tpu's kernels take pe as a static argument and pad its 3 + 6 pe channels
to 48; `wide`: a quarter-octave PE of 123 channels ->
2 x 128 ReLU -> 1) that bracket the first crossing, then `n_refine` Illinois
(or bisection) evaluations; operands of the products are rounded to bf16 and
summed in f32, so the two differ in summation order only. `found` does not
include bounding-sphere validity: the caller masks. There is no gradient.

What bounds it on the card: tensor-core operations (`flops`), 0.603 ms for
the 393,216 rays x 20 evaluations of a training step at 989 TFLOP/s; the
bytes it must move (40 per ray) take 0.005 ms.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from nero_tpu_torch.ops import cuda_build

FIELD_W = 128
FEAT_PAD = 48    # 3 + 6*pe channels padded (pe = 6 -> 39 -> 48)
PE = 6
MAX_PE = 7       # the most octaves whose channels fit FEAT_PAD (csrc/field.cuh FD_MAX_PE)
TILE = 16        # rows per warp tile of the three field kernels (csrc/field.cuh FD_TILE)
# the `wide` topology's encoding: (base frequency, octaves) per double-angle
# chain, quarter-octave spacing up to 2^4.75
WIDE_CHAINS = ((1.0, 5), (2.0 ** 0.25, 5), (2.0 ** 0.5, 5), (2.0 ** 0.75, 5))
WIDE_DIM = 3 + sum(6 * n for _, n in WIDE_CHAINS)  # 123
WIDE_PAD = 128
TOPOLOGIES = ("std", "wide")

launches = {"sphere_march": 0, "sphere_march_wide": 0}
# FLOPs of every counted launch, by `flops(...)` at the launch's shapes (core/mfu.py)
flop_tally = dict.fromkeys(launches, 0.0)


def pack_field_params(params, pe: int = PE, topology: str = "std") -> dict:
    """Pad the field MLP into the kernel layout, detached f32 tensors.
    std: w0 [FEAT_PAD,128], b0 [1,128], w1/w2 [128,128], b1/b2 [1,128],
    w3t [128,8] (col 0 = output), b3 [1,8]. wide (3 dense layers): w0
    [128,128] (123 rows used), b0, w1 [128,128], b1, w2t [128,8], b2 [1,8]."""
    layers = [{k: v.detach() for k, v in l.items()} for l in params["layers"]]
    width = layers[0]["w"].shape[1]
    if topology == "wide":
        if width != FIELD_W or len(layers) != 3 or layers[0]["w"].shape[0] != WIDE_DIM:
            raise NotImplementedError("the wide field is 3 dense layers, 123 -> 128 -> 128 -> 1")
        w0 = F.pad(layers[0]["w"], (0, 0, 0, WIDE_PAD - WIDE_DIM))
        w2t = F.pad(layers[2]["w"][:, :1], (0, 7))
        b2 = F.pad(layers[2]["b"][None, :1], (0, 7))
        return {"w0": w0, "b0": layers[0]["b"][None], "w1": layers[1]["w"],
                "b1": layers[1]["b"][None], "w2t": w2t, "b2": b2}
    if topology != "std":
        raise NotImplementedError(f"field topology {topology!r}")
    if width != FIELD_W or len(layers) != 4:
        raise NotImplementedError("the march kernel takes the 4-layer, 128-wide field")
    in_dim = 3 + 6 * pe
    if in_dim > FEAT_PAD:  # nero_tpu's padding to 48 channels fails there too
        raise ValueError(f"pe = {pe}: {in_dim} channels do not fit the kernels' {FEAT_PAD}")
    w0 = F.pad(layers[0]["w"], (0, 0, 0, FEAT_PAD - in_dim))
    w3t = F.pad(layers[3]["w"][:, :1], (0, 7))
    b3 = F.pad(layers[3]["b"][None, :1], (0, 7))
    return {"w0": w0, "b0": layers[0]["b"][None], "w1": layers[1]["w"],
            "b1": layers[1]["b"][None], "w2": layers[2]["w"], "b2": layers[2]["b"][None],
            "w3t": w3t, "b3": b3}


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def pe_rows(x: torch.Tensor, pe: int = PE) -> torch.Tensor:
    """[..., 3] -> [..., 3 + 6*pe] positional encoding, octave i from octave
    i-1 by the double-angle identities (one sin/cos pair per coordinate);
    channel order of utils/encodings.py::positional_encode."""
    s, c = torch.sin(x), torch.cos(x)
    rows = [x]
    for i in range(pe):
        rows += [s, c]
        if i + 1 < pe:
            s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
    return torch.cat(rows, dim=-1)


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def pe_rows_wide(x: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., WIDE_DIM]: per chain, sin/cos of x * base and four
    double-angle steps (march_kernel.py::_pe_rows_wide); channel order of
    geometry/neural_tracer.py::wide_encode."""
    rows = [x]
    for base, n_oct in WIDE_CHAINS:
        s, c = torch.sin(x * base), torch.cos(x * base)
        for i in range(n_oct):
            rows += [s, c]
            if i + 1 < n_oct:
                s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
    return torch.cat(rows, dim=-1)


def topology_of(packed: dict) -> str:
    return "wide" if "w2t" in packed else "std"


def field_eval_plain(packed: dict, pts: torch.Tensor, pe: int = PE) -> torch.Tensor:
    """The packed field (either topology) at [N,3] points -> [N]; bf16-rounded
    operands, f32 accumulation, f32 biases (march_kernel.py::_field_eval_t,
    ::_field_eval_t_wide)."""
    if topology_of(packed) == "wide":
        feats = F.pad(pe_rows_wide(pts), (0, WIDE_PAD - WIDE_DIM))
        h = torch.relu(_bf(feats) @ _bf(packed["w0"]) + packed["b0"])
        h = torch.relu(_bf(h) @ _bf(packed["w1"]) + packed["b1"])
        return _bf(h) @ _bf(packed["w2t"][:, 0]) + packed["b2"][0, 0]
    feats = F.pad(pe_rows(pts, pe), (0, FEAT_PAD - (3 + 6 * pe)))
    h = torch.relu(_bf(feats) @ _bf(packed["w0"]) + packed["b0"])
    h = torch.relu(_bf(h) @ _bf(packed["w1"]) + packed["b1"])
    h = torch.relu(_bf(h) @ _bf(packed["w2"]) + packed["b2"])
    return _bf(h) @ _bf(packed["w3t"][:, 0]) + packed["b3"][0, 0]


def _secant(lo, hi, flo, fhi):
    denom = flo - fhi
    safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    mid = torch.where(denom.abs() > 1e-12, (flo * hi - fhi * lo) / safe, 0.5 * (lo + hi))
    return torch.minimum(torch.maximum(mid, lo), hi)


@torch.no_grad()
def sphere_march_plain(packed, rays_o, rays_d, t_enter, t_exit, *, pe: int = PE,
                       n_sphere: int = 16, n_refine: int = 8, t0: float = 0.012,
                       margin: float = 0.003, lip: float = 0.9, dt_frac: float = 1.0 / 31.0,
                       cap_frac: float = 0.25, refine: str = "bisect"):
    """Step-by-step transcription of _sphere_march_kernel + _illinois_refine
    (march_kernel.py:208-321), one batched field evaluation per trip; the
    topology is the packed field's. Returns (t_hit [R] f32, found [R] bool)."""
    def field(t):
        return field_eval_plain(packed, rays_o + rays_d * t[:, None], pe)

    chord = t_exit - t_enter
    dt_min, cap = chord * dt_frac, chord * cap_frac

    def step_of(v):
        return torch.minimum(torch.maximum(lip * v - margin, dt_min), cap)

    v0 = field(t_enter)
    found = (v0 <= 0.0) & (t_enter <= t0 + 1e-6)
    t = torch.minimum(t_enter + step_of(v0), t_exit)
    t_prev, v_prev = t_enter, v0
    t_lo, t_hi, f_lo, f_hi = t_enter, t_enter, v0, v0
    for _ in range(1, n_sphere):
        v = field(t)
        cross = (v <= 0.0) & ~found
        t_lo = torch.where(cross, t_prev, t_lo)
        t_hi = torch.where(cross, t, t_hi)
        f_lo = torch.where(cross, v_prev, f_lo)
        f_hi = torch.where(cross, v, f_hi)
        found = found | cross
        t_next = torch.minimum(t + step_of(v), t_exit)
        t_prev = torch.where(found, t_prev, t)
        v_prev = torch.where(found, v_prev, v)
        t = torch.where(found, t, t_next)

    if refine == "illinois":
        for _ in range(n_refine):
            mid = _secant(t_lo, t_hi, f_lo, f_hi)
            v = field(mid)
            pos = v > 0.0
            t_lo, t_hi, f_lo, f_hi = (torch.where(pos, mid, t_lo), torch.where(pos, t_hi, mid),
                                      torch.where(pos, v, 0.5 * f_lo),
                                      torch.where(pos, 0.5 * f_hi, v))
        # one last secant step on the endpoint values, no evaluation
        return _secant(t_lo, t_hi, f_lo, f_hi), found
    if refine != "bisect":
        raise NotImplementedError(refine)
    for _ in range(n_refine):
        mid = 0.5 * (t_lo + t_hi)
        pos = field(mid) > 0.0
        t_lo, t_hi = torch.where(pos, mid, t_lo), torch.where(pos, t_hi, mid)
    return 0.5 * (t_lo + t_hi), found


# ---------------------------------------------------------------------------
# kernel plumbing
# ---------------------------------------------------------------------------


def buffer_elems(wide: bool) -> tuple:
    """(bf16 weight elements, f32 elements) of the kernels' field buffers
    (csrc/field.cuh FieldDims)."""
    if wide:
        return (WIDE_PAD + FIELD_W) * FIELD_W, 3 * FIELD_W + 4
    return (FEAT_PAD + 2 * FIELD_W) * FIELD_W, 4 * FIELD_W + 4


def field_lib(name: str, fn_argtypes: list):
    """The library of a kernel on csrc/field.cuh's engine (`name` is both
    the source and its entry point), typed and checked against this module's
    layout and TILE on first use."""
    lib = cuda_build.load(name)
    if not getattr(lib, "_nero_typed", False):
        i = ctypes.c_int
        lib_tile, w_elems, f_elems = (getattr(lib, f"{name}_{k}")
                                      for k in ("tile", "weight_elems", "float_elems"))
        lib_tile.restype, lib_tile.argtypes = i, []
        for fn in (w_elems, f_elems):
            fn.restype, fn.argtypes = ctypes.c_size_t, [i]
        entry = getattr(lib, name)
        entry.restype, entry.argtypes = i, fn_argtypes
        if lib_tile() != TILE or any((w_elems(w), f_elems(w)) != buffer_elems(bool(w))
                                 for w in (0, 1)):
            raise RuntimeError(f"csrc/{name}.cu layout differs from ops/sphere_march.py")
        lib._nero_typed = True
    return lib


def _lib():
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return field_lib("sphere_march", [vp, vp, vp, vp, i, vp, vp, i, i, i, i, i, f, f, f, f, f,
                                      vp, vp, vp])


def kernel_buffers(packed: dict):
    """`pack_field_params` layout -> (bf16 stacked 128-column weights, f32
    [biases, output weights, output bias, pad]) as the kernels read them."""
    if topology_of(packed) == "wide":
        ws, fs = ("w0", "w1"), ("b0", "b1")
        w_out, b_out = packed["w2t"][:, 0], packed["b2"][0, :4]
    else:
        ws, fs = ("w0", "w1", "w2"), ("b0", "b1", "b2")
        w_out, b_out = packed["w3t"][:, 0], packed["b3"][0, :4]
    W = torch.cat([packed[k] for k in ws]).to(torch.bfloat16).contiguous()
    Fv = torch.cat([packed[k][0] for k in fs] + [w_out, b_out]).float().contiguous()
    if (W.numel(), Fv.numel()) != buffer_elems("w2t" in packed):
        raise ValueError(f"packed field has {W.numel()} weights and {Fv.numel()} floats")
    return W, Fv


def check_packed(packed: dict, topology: str, pe: int, kernel: bool) -> None:
    """Raise where `topology` is not the packed field's, or (for a kernel
    launch) on an encoding that the kernels do not take: `std` at pe 0-7, as
    nero_tpu's pack_field_params pads no more than 48 channels."""
    if topology not in TOPOLOGIES or topology_of(packed) != topology:
        raise ValueError(f"topology {topology!r} with a {topology_of(packed)!r} packed field")
    if kernel and topology == "std" and not 0 <= pe <= MAX_PE:
        raise NotImplementedError(f"the field kernels take pe 0-{MAX_PE}, got {pe}")


def prep(a: torch.Tensor) -> torch.Tensor:
    return a.detach().float().contiguous()


def _launch(W, Fv, wide, rays_o, rays_d, t_enter, t_exit, n_sphere, n_refine, illinois,
            t0_eps, margin, lip, dt_frac, cap_frac, pe: int = PE):
    r = rays_o.shape[0]
    dev = rays_o.device
    t_out = torch.empty(r, device=dev)
    found = torch.empty(r, dtype=torch.bool, device=dev)
    if r == 0:  # nothing to launch, nothing counted
        return t_out, found
    rc = _lib().sphere_march(rays_o.data_ptr(), rays_d.data_ptr(), t_enter.data_ptr(),
                             t_exit.data_ptr(), r, W.data_ptr(), Fv.data_ptr(), int(wide), pe,
                             n_sphere, n_refine, int(illinois), t0_eps, margin, lip, dt_frac, cap_frac,
                             t_out.data_ptr(), found.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "sphere_march")
    launches["sphere_march_wide" if wide else "sphere_march"] += 1
    flop_tally["sphere_march_wide" if wide else "sphere_march"] += flops(
        r, n_sphere, n_refine, "wide" if wide else "std", pe)
    return t_out, found


@torch.no_grad()
def sphere_march(packed, rays_o, rays_d, t_enter, t_exit, *, pe: int = PE, n_sphere: int = 16,
                 n_refine: int = 8, t0: float = 0.012, margin: float = 0.003,
                 lip: float = 0.9, dt_frac: float = 1.0 / 31.0, cap_frac: float = 0.25,
                 refine: str = "bisect", topology: str = "std"):
    """Sphere-traced march of [R] rays -> (t_hit [R], found [R] bool), both
    detached: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    check_packed(packed, topology, pe, kernel=rays_o.device.type != "cpu")
    if rays_o.device.type == "cpu":
        return sphere_march_plain(packed, rays_o, rays_d, t_enter, t_exit, pe=pe,
                                  n_sphere=n_sphere, n_refine=n_refine, t0=t0, margin=margin,
                                  lip=lip, dt_frac=dt_frac, cap_frac=cap_frac, refine=refine)
    if refine not in ("illinois", "bisect") or n_sphere < 1:
        raise NotImplementedError(f"sphere_march kernel: refine={refine!r} n_sphere={n_sphere}")
    W, Fv = kernel_buffers(packed)
    return _launch(W, Fv, topology == "wide", prep(rays_o), prep(rays_d), prep(t_enter),
                   prep(t_exit), n_sphere, n_refine, refine == "illinois", float(t0 + 1e-6),
                   float(margin), float(lip), float(dt_frac), float(cap_frac), pe)


# ---------------------------------------------------------------------------
# the least work the function needs (for the bound beside the kernel time)
# ---------------------------------------------------------------------------

# per evaluation, at the true widths: std (3 + 6 pe) x 128, two 128 x 128 and
# 128 x 1; wide 123 x 128, one 128 x 128 and 128 x 1
EVAL_FLOPS = 2 * ((3 + 6 * PE) * FIELD_W + 2 * FIELD_W * FIELD_W + FIELD_W)
EVAL_FLOPS_WIDE = 2 * (WIDE_DIM * FIELD_W + FIELD_W * FIELD_W + FIELD_W)


def eval_flops(topology: str, pe: int = PE) -> int:
    if topology == "wide":
        return EVAL_FLOPS_WIDE
    return 2 * ((3 + 6 * pe) * FIELD_W + 2 * FIELD_W * FIELD_W + FIELD_W)


def flops(r: int, n_sphere: int, n_refine: int, topology: str = "std", pe: int = PE) -> float:
    """Every ray runs every trip: r x (n_sphere + n_refine) evaluations."""
    return float(r) * (n_sphere + n_refine) * eval_flops(topology, pe)


def min_bytes(r: int, topology: str = "std") -> float:
    """Origins, directions and the t range read once (8 f32 per ray), t and
    found written once (counted as 2 f32, as the TPU kernel's rows), and the
    bf16 weights."""
    return r * (8 + 2) * 4 + buffer_elems(topology == "wide")[0] * 2
