"""Sphere-march visibility tracing of the distilled field: the CUDA kernel
and its plain version.

Replaces nero_tpu/ops/pallas/march_kernel.py::sphere_march_fused (:358, its
pallas_call at :338) and keeps nero_tpu/ops/pallas/field_kernel.py's
`pack_field_params` layout (:45-52). The kernel source is
csrc/sphere_march.cu; its header comment gives the design. `sphere_march`
launches the kernel for CUDA tensors and runs `sphere_march_plain` for CPU
tensors, and only then. Both compute, per ray, `n_sphere` sphere-trace
evaluations of the PE6 -> 3 x 128 ReLU -> 1 field that bracket the first
crossing, then `n_refine` Illinois (or bisection) evaluations; operands of
the products are rounded to bf16 and summed in f32, so the two differ in
summation order only. `found` does not include bounding-sphere validity: the
caller masks. There is no gradient.

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
TILE = 128       # rays per block (csrc/sphere_march.cu SM_RAYS)

launches = {"sphere_march": 0}


def pack_field_params(params, pe: int = PE) -> dict:
    """Pad the 4-layer field MLP into the kernel layout: w0 [FEAT_PAD,128],
    b0 [1,128], w1/w2 [128,128], b1/b2 [1,128], w3t [128,8] (col 0 = output),
    b3 [1,8]; detached f32 tensors."""
    layers = [{k: v.detach() for k, v in l.items()} for l in params["layers"]]
    width = layers[0]["w"].shape[1]
    if width != FIELD_W or len(layers) != 4:
        raise NotImplementedError("the march kernel takes the 4-layer, 128-wide field")
    in_dim = 3 + 6 * pe
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


def field_eval_plain(packed: dict, pts: torch.Tensor, pe: int = PE) -> torch.Tensor:
    """The packed field at [N,3] points -> [N]; bf16-rounded operands, f32
    accumulation, f32 biases (march_kernel.py::_field_eval_t)."""
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
    (march_kernel.py:208-321), one batched field evaluation per trip.
    Returns (t_hit [R] f32, found [R] bool)."""
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


def _lib():
    lib = cuda_build.load("sphere_march")
    if not getattr(lib, "_nero_typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sphere_march_tile.restype = i
        lib.sphere_march_tile.argtypes = []
        lib.sphere_march_weight_elems.restype = ctypes.c_size_t
        lib.sphere_march_weight_elems.argtypes = []
        lib.sphere_march_float_elems.restype = ctypes.c_size_t
        lib.sphere_march_float_elems.argtypes = []
        lib.sphere_march.restype = i
        lib.sphere_march.argtypes = [vp, vp, vp, vp, i, vp, vp, i, i, i, f, f, f, f, f,
                                     vp, vp, vp]
        if (lib.sphere_march_tile() != TILE
                or lib.sphere_march_weight_elems() != (FEAT_PAD + 2 * FIELD_W) * FIELD_W
                or lib.sphere_march_float_elems() != 4 * FIELD_W + 4):
            raise RuntimeError("csrc/sphere_march.cu layout differs from ops/sphere_march.py")
        lib._nero_typed = True
    return lib


def kernel_buffers(packed: dict):
    """`pack_field_params` layout -> (bf16 [w0; w1; w2] flat, f32 [b0 b1 b2
    w3 b3 pad]) as the kernel reads them."""
    W = torch.cat([packed["w0"], packed["w1"], packed["w2"]]).to(torch.bfloat16).contiguous()
    Fv = torch.cat([packed["b0"][0], packed["b1"][0], packed["b2"][0], packed["w3t"][:, 0],
                    packed["b3"][0, :4]]).float().contiguous()
    return W, Fv


def _launch(W, Fv, rays_o, rays_d, t_enter, t_exit, n_sphere, n_refine, illinois, t0_eps,
            margin, lip, dt_frac, cap_frac):
    r = rays_o.shape[0]
    dev = rays_o.device
    t_out = torch.empty(r, device=dev)
    found = torch.empty(r, dtype=torch.bool, device=dev)
    rc = _lib().sphere_march(rays_o.data_ptr(), rays_d.data_ptr(), t_enter.data_ptr(),
                             t_exit.data_ptr(), r, W.data_ptr(), Fv.data_ptr(), n_sphere,
                             n_refine, int(illinois), t0_eps, margin, lip, dt_frac, cap_frac,
                             t_out.data_ptr(), found.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "sphere_march")
    launches["sphere_march"] += 1
    return t_out, found


@torch.no_grad()
def sphere_march(packed, rays_o, rays_d, t_enter, t_exit, *, pe: int = PE, n_sphere: int = 16,
                 n_refine: int = 8, t0: float = 0.012, margin: float = 0.003,
                 lip: float = 0.9, dt_frac: float = 1.0 / 31.0, cap_frac: float = 0.25,
                 refine: str = "bisect"):
    """Sphere-traced march of [R] rays -> (t_hit [R], found [R] bool), both
    detached: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if rays_o.device.type == "cpu":
        return sphere_march_plain(packed, rays_o, rays_d, t_enter, t_exit, pe=pe,
                                  n_sphere=n_sphere, n_refine=n_refine, t0=t0, margin=margin,
                                  lip=lip, dt_frac=dt_frac, cap_frac=cap_frac, refine=refine)
    if pe != PE or refine not in ("illinois", "bisect") or n_sphere < 1:
        raise NotImplementedError(f"sphere_march kernel: pe={pe} refine={refine!r} "
                                  f"n_sphere={n_sphere}")
    if tuple(packed["w0"].shape) != (FEAT_PAD, FIELD_W):
        raise ValueError(f"packed field has w0 {tuple(packed['w0'].shape)}")
    W, Fv = kernel_buffers(packed)
    prep = lambda a: a.detach().float().contiguous()
    return _launch(W, Fv, prep(rays_o), prep(rays_d), prep(t_enter), prep(t_exit), n_sphere,
                   n_refine, refine == "illinois", float(t0 + 1e-6), float(margin), float(lip),
                   float(dt_frac), float(cap_frac))


# ---------------------------------------------------------------------------
# the least work the function needs (for the bound beside the kernel time)
# ---------------------------------------------------------------------------

# per evaluation, at the true widths: 39 x 128, two 128 x 128 and 128 x 1
EVAL_FLOPS = 2 * ((3 + 6 * PE) * FIELD_W + 2 * FIELD_W * FIELD_W + FIELD_W)


def flops(r: int, n_sphere: int, n_refine: int) -> float:
    """Every ray runs every trip: r x (n_sphere + n_refine) evaluations."""
    return float(r) * (n_sphere + n_refine) * EVAL_FLOPS


def min_bytes(r: int) -> float:
    """Origins, directions and the t range read once (8 f32 per ray), t and
    found written once (counted as 2 f32, as the TPU kernel's rows), and the
    bf16 weights."""
    return r * (8 + 2) * 4 + (FEAT_PAD + 2 * FIELD_W) * FIELD_W * 2
