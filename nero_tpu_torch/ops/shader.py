"""Whole Stage-I shader (six heads, seven with the human light, and their
IDE/PE/IPE encodings): CUDA kernel and its plain version.

Replaces nero_tpu/ops/pallas/shader_kernel.py::shader_fused_raw (:552),
whose pallas_calls are nero_shader_fwd_f* (:467) and nero_shader_bwd_f*
(:494), in all four variants: default, `sphere_direction` (:289-314),
`human_light` (`_human_block`, :219-255) and both. The kernel source is
csrc/shader.cu; its header comment gives the design, including the
hand-derived backward that replaces the in-kernel jax.vjp. `shader_raw`
launches the kernel for CUDA tensors and runs `shader_raw_plain` (plain
torch, autograd) for CPU tensors, and only then. The activations, the human
mixing, the FG-LUT lookup and sRGB stay outside the kernel
(fields/app_shading.py), as on the TPU.

The kernel takes every configuration of nero_tpu's kernel (256 feats, IDE
degree up to 5) at light_pos_freq 0-128 (MAX_LIGHT_PE: past octave 127 the
frequency 2^i is no finite f32, in either package): the IDE degree and the
light PE's octaves are the library's (one build per pair, `defines`), and
the launch counters of a pair other than the shipped (5, 8) carry its suffix
`_d<ide_deg>p<light_pos_freq>` (`shader_fwd_d5p32`, ...). Where a light
head's input outgrows one 256-wide tile (degree 5 from light_pos_freq 31
on), the kernel builds it in 256-column windows and takes its input
cotangent in 128-column pieces (csrc/shader.cu's header).

What bounds it on the card: tensor-core operations (`flops`), about 0.17 ms
forward and 0.5 ms backward at N = 65,536 and 989 TFLOP/s; the bytes it
must move (geometry and feats in, 24 raw channels out) are ~75 MB, 0.02 ms.
The forward is one launch over 128-row tiles, the same engine as the
backward's recompute. The backward is three launches (recompute and reverse sweep, the weight-
and bias-gradient pass, the reduction of its partials) through a scratch of
X, H and GZ in device memory: 1.5 GB at N = 65,536, 1.7 GB with the human
head (`bwd_buffers`).

`shader_raw_scenes` is the same function over S scenes' weights stacked on a
leading axis (parallel/scenes.py), as nero_tpu's `jax.vmap` of the multi-
scene step batches its pallas_calls: one launch each way for all scenes, on
a grid with a scene dimension; each scene's outputs and gradients are its
one-scene launch's to the bit. Its launch counters are `shader_fwd_scenes`
and `shader_bwd_scenes` with the variant's suffix. Off the kernel it runs
the plain version with each scene's heads on its rows (`scene_heads`).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from nero_tpu_torch.ops import cuda_build
from nero_tpu_torch.ops.mlp import predictor_raw, resolve_weight_norm
from nero_tpu_torch.ops.predictor import predictor_scenes
from nero_tpu_torch.parallel.scenes import scene_map
from nero_tpu_torch.utils.encodings import (ide_dim, ide_kernel_table, integrated_dir_encode,
                                            integrated_pos_encode, positional_encode,
                                            positional_encode_dim)
from nero_tpu_torch.utils.sphere import get_sphere_intersection, offset_points_to_sphere

TILE = 128       # rows per block, forward and backward (csrc/shader.cu PB)
HID = 256
OUT = 24
DGEO = 9         # gradient rows: d pts, d normal, d view
HEAD_ORDER = ("metallic", "roughness", "albedo", "outer_light", "inner_light",
              "inner_weight")
HUMAN_HEAD = "human_light"
DO = 16
DEFAULT_ENC = (5, 8)   # (ide_deg, light_pos_freq) of the library built without defines
MAX_IDE_DEG = 5
MAX_LIGHT_PE = 128     # octaves 0-127: 2^i stays a finite f32 (nero_tpu's kernel states no limit)


def _suffix(sphere, human, enc=DEFAULT_ENC) -> str:
    return (("_sphere" if sphere else "") + ("_human" if human else "")
            + ("" if tuple(enc) == DEFAULT_ENC else f"_d{enc[0]}p{enc[1]}"))


def defines(enc) -> tuple:
    """The build's -D macros for (ide_deg, light_pos_freq): none at (5, 8)."""
    ide_deg, light_pe = enc
    return ((() if ide_deg == DEFAULT_ENC[0] else (("NERO_IDE_DEG", ide_deg),))
            + (() if light_pe == DEFAULT_ENC[1] else (("NERO_LIGHT_PE", light_pe),)))


# the shipped encodings' counters; another pair's are added at its first launch
# (`_scenes`: one launch for all scenes of the multi-scene step)
launches = {f"shader_{d}{b}{_suffix(s, h)}": 0 for b in ("", "_scenes") for h in (0, 1)
            for s in (0, 1) for d in ("fwd", "bwd")}
# FLOPs of every counted launch, by `flops(...)` at the launch's shapes (core/mfu.py)
flop_tally = dict.fromkeys(launches, 0.0)


def _count(name: str, flop: float) -> None:
    launches[name] = launches.get(name, 0) + 1
    flop_tally[name] = flop_tally.get(name, 0.0) + flop


class _Variant(NamedTuple):
    feats_dim: int
    ide_deg: int
    light_pos_freq: int
    sphere_direction: bool
    human_light: bool


def variant_cfg(sphere, human, enc=DEFAULT_ENC) -> _Variant:
    """What `head_dims` reads of a shader config, for a kernel variant at
    the encodings enc = (ide_deg, light_pos_freq)."""
    return _Variant(HID, enc[0], enc[1], bool(sphere), bool(human))


def encodings(cfg) -> tuple:
    return (cfg.ide_deg, cfg.light_pos_freq)


def variant(cfg) -> str:
    """Suffix of the launch counters of cfg's kernel variant."""
    return _suffix(cfg.sphere_direction, cfg.human_light, encodings(cfg))


def supported(cfg) -> bool:
    """nero_tpu's rule (fields/app_shading.py::fused_shader_supported: 256
    feats, ide_deg <= 5), and light_pos_freq 0-MAX_LIGHT_PE."""
    return (cfg.feats_dim == HID and cfg.ide_deg <= MAX_IDE_DEG
            and 0 <= cfg.light_pos_freq <= MAX_LIGHT_PE)


def head_order(cfg) -> tuple:
    return HEAD_ORDER + ((HUMAN_HEAD,) if cfg.human_light else ())


def geo_width(cfg) -> int:
    """Geometry floats per row: pts, normal, view and, with the human light,
    the camera pose (R row-major, t)."""
    return 21 if cfg.human_light else 9


def head_dims(cfg) -> dict:
    """Unpadded (d_in, d_out) per head."""
    sph = ide_dim(cfg.ide_deg)
    pos = positional_encode_dim(3, cfg.light_pos_freq)
    ref = positional_encode_dim(3, 6)
    f = cfg.feats_dim
    dims = {"metallic": (f + 3, 1), "roughness": (f + 3, 1), "albedo": (f + 3, 3),
            "outer_light": (sph * (2 if cfg.sphere_direction else 1), 3),
            "inner_light": (pos + sph, 3), "inner_weight": (pos + ref, 1)}
    if cfg.human_light:
        dims[HUMAN_HEAD] = (2 * 2 * 6, 4)
    return dims


def head_pad(cfg) -> dict:
    """Padded input width per head (csrc/shader.cu Var::head_di)."""
    return {name: -(-d_in // 16) * 16 for name, (d_in, _) in head_dims(cfg).items()}


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)


def unpack_raw(out: torch.Tensor, human: bool = False) -> dict:
    """Packed [..., 24] -> named raw outputs (shader_kernel.py:262-265)."""
    raw = {"metallic_z": out[..., 0:1], "roughness_z": out[..., 1:2],
           "albedo_z": out[..., 2:5], "diffuse_light_z": out[..., 5:8],
           "direct_light_z": out[..., 8:11], "inner_light_z": out[..., 11:14],
           "occ_z": out[..., 14:15], "reflective": out[..., 15:18], "NoV": out[..., 18:19]}
    if human:
        raw["human_z"] = out[..., 19:23]
        raw["human_hits"] = out[..., 23:24].detach()
    return raw


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def sphere_dir_enc(cfg, points, directions, roughness) -> torch.Tensor:
    """IDE of the normalised point where the ray from `points` (pulled inside
    radius 0.999) along `directions` leaves the unit sphere
    (nero_tpu/fields/app_shading.py:127-131)."""
    sph = offset_points_to_sphere(points)
    hit = _normalize(sph + directions * get_sphere_intersection(sph, directions))
    return integrated_dir_encode(hit, roughness, cfg.ide_deg)


def human_light_input(points, reflective, human_poses, roughness):
    """(IPE [..., 24] of the camera-plane hit, hit mask [..., 1] as float) of
    nero_tpu/fields/app_shading.py:106-115."""
    R, t = human_poses[..., :, :3], human_poses[..., :, 3]
    pts_h = torch.einsum("...ij,...j->...i", R, points) + t
    dirs_h = torch.einsum("...ij,...j->...i", R, reflective)
    hits = torch.abs(dirs_h[..., 2:3]) > 1e-4
    dirs_z = torch.where(hits, dirs_h[..., 2:3], torch.full_like(dirs_h[..., 2:3], 1e-4))
    dist = -pts_h[..., 2:3] / dirs_z
    mean = (pts_h[..., :2] + dist * dirs_h[..., :2]) * 0.3
    var = roughness * (dist * 0.3) ** 2
    hits = hits & (torch.linalg.norm(mean, dim=-1, keepdim=True) < 1.5) & (dist > 0)
    hitsf = hits.to(mean.dtype)
    mean = mean * hitsf
    var = (var * hitsf).expand(mean.shape)
    return integrated_pos_encode(mean, var, 0, 6), hitsf


def shader_raw_plain(params, cfg, points, normals, view_dirs, feats,
                     human_poses=None, head=predictor_raw) -> torch.Tensor:
    """Packed raw outputs [..., 24] in plain torch, every variant. `head`
    (layers, x) -> pre-activation output evaluates one 4-layer head: the
    per-head shader path (fields/app_shading.py::heads_raw) passes its own."""
    normals = _normalize(normals)
    view_dirs = _normalize(view_dirs)
    nov = torch.sum(view_dirs * normals, -1, keepdim=True)
    reflective = nov * normals * 2 - view_dirs
    x_mat = torch.cat([feats, points], -1)
    metallic_z = head(params["metallic"], x_mat)
    roughness_z = head(params["roughness"], x_mat)
    albedo_z = head(params["albedo"], x_mat)
    roughness = torch.sigmoid(roughness_z)
    ones = torch.ones_like(points[..., :1])
    ide_n = integrated_dir_encode(normals, ones, cfg.ide_deg)
    ide_r = integrated_dir_encode(reflective, roughness, cfg.ide_deg)
    outer_n, outer_r = ide_n, ide_r
    if cfg.sphere_direction:
        outer_n = torch.cat([ide_n, sphere_dir_enc(cfg, points, normals, ones)], -1)
        outer_r = torch.cat([ide_r, sphere_dir_enc(cfg, points, reflective, roughness)], -1)
    diffuse_z = head(params["outer_light"], outer_n)
    direct_z = head(params["outer_light"], outer_r)
    pe_pts = positional_encode(points, cfg.light_pos_freq)
    inner_z = head(params["inner_light"], torch.cat([pe_pts, ide_r], -1))
    occ_in = torch.cat([pe_pts, positional_encode(reflective, 6)], -1).detach()
    occ_z = head(params["inner_weight"], occ_in)
    if cfg.human_light:
        ipe, hitsf = human_light_input(points, reflective, human_poses, roughness)
        tail = torch.cat([head(params[HUMAN_HEAD], ipe), hitsf], -1)
    else:
        tail = torch.zeros(points.shape[:-1] + (OUT - 19,), dtype=points.dtype,
                           device=points.device)
    return torch.cat([metallic_z, roughness_z, albedo_z, diffuse_z, direct_z, inner_z,
                      occ_z, reflective, nov, tail], -1)


# ---------------------------------------------------------------------------
# kernel plumbing
# ---------------------------------------------------------------------------


def _lib(enc=DEFAULT_ENC):
    lib = cuda_build.load("shader", defines(enc))
    if not getattr(lib, "_nero_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.shader_weight_elems.restype = ctypes.c_size_t
        lib.shader_weight_elems.argtypes = [i, i]
        lib.shader_tile.restype = i
        lib.shader_tile.argtypes = []
        for fn in ("shader_scratch_elems", "shader_part_elems"):
            getattr(lib, fn).restype = ctypes.c_size_t
            getattr(lib, fn).argtypes = [i, i, i]
        lib.shader_fwd.restype = i
        lib.shader_fwd.argtypes = [vp, vp, i, vp, vp, vp, i, i, vp, vp]
        lib.shader_bwd.restype = i
        lib.shader_bwd.argtypes = [vp, vp, i, vp, vp, vp, i, i, vp, vp, vp, vp, vp, vp, vp, vp]
        lib.shader_bwd_sweep.restype = i
        lib.shader_bwd_sweep.argtypes = [vp, vp, i, vp, vp, vp, i, i, vp, vp, vp, vp, vp]
        lib.shader_bwd_params.restype = i
        lib.shader_bwd_params.argtypes = [i, i, i, vp, vp, vp, vp, vp]
        # S scenes in one launch (S = 1: one scene): n, then S
        lib.shader_fwd_scenes.restype = i
        lib.shader_fwd_scenes.argtypes = [vp, vp, i, i, vp, vp, vp, i, i, vp, vp]
        lib.shader_bwd_scenes.restype = i
        lib.shader_bwd_scenes.argtypes = [vp, vp, i, i, vp, vp, vp, i, i, vp, vp, vp, vp, vp,
                                          vp, vp, vp]
        if lib.shader_tile() != TILE:
            raise RuntimeError("csrc/shader.cu tile differs from ops/shader.py")
        lib._nero_typed = True
    return lib


def _head_shapes(di: int):
    return ((di, HID), (HID, HID), (HID, HID), (HID, DO))


def weight_elems(pads) -> int:
    """Packed weight count for the padded input widths `pads` (one per head)."""
    return sum(r * c for di in pads for r, c in _head_shapes(di))


def pack_weights(ws, bs, pads):
    """Resolved weights / biases (4 per head, in head order) -> (packed bf16,
    bias f32 [heads, 4, 256]) in the kernel layout."""
    parts = []
    bias = torch.zeros(len(pads), 4, HID, dtype=torch.float32, device=ws[0].device)
    for h, di in enumerate(pads):
        for l, (r, c) in enumerate(_head_shapes(di)):
            w = ws[4 * h + l]
            parts.append(F.pad(w, (0, c - w.shape[1], 0, r - w.shape[0])).reshape(-1))
            b = bs[4 * h + l]
            bias[h, l, :b.shape[0]] = b
    return torch.cat(parts).to(torch.bfloat16).contiguous(), bias


def unpack_grads(dW: torch.Tensor, dB: torch.Tensor, pads, dims):
    """Kernel-layout gradients -> per-layer (dw [in,out], db [out]); `dims`
    holds the unpadded (d_in, d_out) per head."""
    dws, dbs = [], []
    sizes = [r * c for di in pads for r, c in _head_shapes(di)]
    chunks = torch.split(dW, sizes)
    for h, (di, (d_in, d_out)) in enumerate(zip(pads, dims)):
        for l, (r, c) in enumerate(_head_shapes(di)):
            g = chunks[4 * h + l].view(r, c)
            rows = d_in if l == 0 else HID
            cols = d_out if l == 3 else HID
            dws.append(g[:rows, :cols])
            dbs.append(dB[h, l, :cols])
    return dws, dbs


_IDE_TABLES: dict = {}


def ide_table_on(device, ide_deg: int = 5) -> torch.Tensor:
    """The IDE table of degree `ide_deg` (utils/encodings.py::
    ide_kernel_table) on `device`, copied there once: a host-to-device copy
    per call would stall the host on the stream."""
    key = (str(device), ide_deg)
    if key not in _IDE_TABLES:
        _IDE_TABLES[key] = torch.as_tensor(ide_kernel_table(ide_deg), device=device)
    return _IDE_TABLES[key]


def _fwd(geo, feats, W, B, sphere: int, human: int, enc=DEFAULT_ENC) -> torch.Tensor:
    """One forward launch on packed weights, for one scene (geo [n, 9 or 21],
    feats [n, 256], W [w_total], B [heads, 4, 256]) or for S (a leading
    scene axis on each) -> raw [..., n, 24]. No rows: an empty output, no
    launch. A launch for scenes counts under `shader_fwd_scenes<variant>`."""
    lead, n = geo.shape[:-2], geo.shape[-2]
    if n == 0:
        return torch.empty(lead + (0, OUT), device=geo.device)
    lib = _lib(enc)
    if lib.shader_weight_elems(sphere, human) != W.shape[-1]:
        raise RuntimeError("csrc/shader.cu layout differs from ops/shader.py")
    out = torch.empty(lead + (n, OUT), device=geo.device)
    name = "shader_fwd" + ("_scenes" if lead else "")
    rc = lib.shader_fwd_scenes(geo.data_ptr(), feats.data_ptr(), n, math.prod(lead),
                               W.data_ptr(), B.data_ptr(),
                               ide_table_on(geo.device, enc[0]).data_ptr(), sphere, human,
                               out.data_ptr(), torch.cuda.current_stream(geo.device).cuda_stream)
    cuda_build.check(rc, name)
    _count(name + _suffix(sphere, human, enc),
           flops(math.prod(lead) * n, variant_cfg(sphere, human, enc)))
    return out


def bwd_buffers(n: int, sphere: int, human: int, dev, enc=DEFAULT_ENC, n_scenes: int = 1):
    """The backward's scratch (bf16: X of every input slot, H and GZ of every
    layer of every head evaluation, in 8 x 8 pieces) and its per-chunk
    partials (f32), one torch.empty each, sized by the library; S scenes of
    n rows take S times one scene's."""
    lib = _lib(enc)
    return (torch.empty(n_scenes * lib.shader_scratch_elems(n, sphere, human),
                        dtype=torch.bfloat16, device=dev),
            torch.empty(n_scenes * lib.shader_part_elems(n, sphere, human), device=dev))


def _bwd(geo, feats, W, B, sphere: int, human: int, gout, enc=DEFAULT_ENC):
    """One backward call (recompute and sweep, parameter pass, reduction),
    for one scene or S as `_fwd`: gout [..., n, 24] -> (dgeo [..., n, 9],
    dfeats [..., n, 256], dW packed f32, dB)."""
    lead, n = geo.shape[:-2], geo.shape[-2]
    dev = geo.device
    lib = _lib(enc)
    scratch, part = bwd_buffers(n, sphere, human, dev, enc, math.prod(lead))
    dgeo = torch.empty(lead + (n, DGEO), device=dev)
    dfeats = torch.empty(lead + (n, HID), device=dev)
    # no rows, no launch: the kernels write every element of dW and dB otherwise
    new = torch.empty if n else torch.zeros
    dW = new(W.shape, device=dev)
    dB = new(B.shape, device=dev)
    name = "shader_bwd" + ("_scenes" if lead else "")
    rc = lib.shader_bwd_scenes(geo.data_ptr(), feats.data_ptr(), n, math.prod(lead),
                               W.data_ptr(), B.data_ptr(), ide_table_on(dev, enc[0]).data_ptr(),
                               sphere, human, gout.data_ptr(), dgeo.data_ptr(), dfeats.data_ptr(),
                               scratch.data_ptr(), part.data_ptr(), dW.data_ptr(), dB.data_ptr(),
                               torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, name)
    _count(name + _suffix(sphere, human, enc),
           flops(math.prod(lead) * n, variant_cfg(sphere, human, enc), backward=True))
    return dgeo, dfeats, dW, dB


class _ShaderFn(torch.autograd.Function):
    """spec = (sphere, human, padded widths, unpadded dims, (ide_deg,
    light_pos_freq)) of the variant."""

    @staticmethod
    def forward(ctx, geo, feats, spec, *wb):
        sphere, human, pads, _, enc = spec
        nw = 4 * len(pads)
        W, B = pack_weights(wb[:nw], wb[nw:], pads)
        out = _fwd(geo, feats, W, B, sphere, human, enc)
        ctx.save_for_backward(geo, feats, W, B)
        ctx.spec = spec
        return out

    @staticmethod
    def backward(ctx, gout):
        geo, feats, W, B = ctx.saved_tensors
        sphere, human, pads, dims, enc = ctx.spec
        dgeo, dfeats, dW, dB = _bwd(geo, feats, W, B, sphere, human, gout.float().contiguous(),
                                    enc)
        dws, dbs = unpack_grads(dW, dB, pads, dims)
        if human:  # the poses are data: no gradient
            dgeo = torch.cat([dgeo, dgeo.new_zeros(geo.shape[0], geo.shape[1] - DGEO)], -1)
        return (dgeo, dfeats, None, *dws, *dbs)


def pack_scenes(ws, bs, pads):
    """Stacked resolved weights / biases ([S, ...] each, 4 per head, in head
    order) -> (packed bf16 [S, w_total], bias f32 [S, heads, 4, 256]), each
    scene packed as one scene's is."""
    packs = [pack_weights([w[s] for w in ws], [b[s] for b in bs], pads)
             for s in range(ws[0].shape[0])]
    return (torch.stack([p[0] for p in packs]).contiguous(),
            torch.stack([p[1] for p in packs]).contiguous())


class _ShaderScenesFn(torch.autograd.Function):
    """_ShaderFn over S scenes: geo [S, n, ...], feats [S, n, 256], the
    weights and biases stacked [S, ...]."""

    @staticmethod
    def forward(ctx, geo, feats, spec, *wb):
        sphere, human, pads, _, enc = spec
        nw = 4 * len(pads)
        W, B = pack_scenes(wb[:nw], wb[nw:], pads)
        out = _fwd(geo, feats, W, B, sphere, human, enc)
        ctx.save_for_backward(geo, feats, W, B)
        ctx.spec = spec
        return out

    @staticmethod
    def backward(ctx, gout):
        geo, feats, W, B = ctx.saved_tensors
        sphere, human, pads, dims, enc = ctx.spec
        dgeo, dfeats, dW, dB = _bwd(geo, feats, W, B, sphere, human,
                                           gout.float().contiguous(), enc)
        per_scene = [unpack_grads(dW[s], dB[s], pads, dims) for s in range(W.shape[0])]
        dws = [torch.stack(g) for g in zip(*[p[0] for p in per_scene])]
        dbs = [torch.stack(g) for g in zip(*[p[1] for p in per_scene])]
        if human:  # the poses are data: no gradient
            dgeo = torch.cat([dgeo, dgeo.new_zeros(geo.shape[:2] + (geo.shape[2] - DGEO,))], -1)
        return (dgeo, dfeats, None, *dws, *dbs)


def scene_heads(n_scenes: int, head=predictor_raw, fused: bool = False):
    """A `head` for `shader_raw_plain` over S scenes' scene-major rows with
    the heads' layers stacked on a leading scene axis: scene s's head on its
    part of the rows. `fused` (the per-head shader's `fused_heads`): one
    launch of the predictor kernel each way for all scenes
    (`ops/predictor.py::predictor_scenes`, scene by scene on CPU tensors)."""
    if fused:
        return lambda layers, x: predictor_scenes(layers, x, n_scenes)
    return lambda layers, x: scene_map(head, n_scenes, layers, x)


def shader_raw_scenes(params, cfg, n_scenes: int, points, normals, view_dirs, feats,
                      human_poses=None) -> torch.Tensor:
    """`shader_raw` of S scenes: params stacked on a leading scene axis, the
    rows of every argument scene-major (scene s's the s-th of S equal parts
    of the leading axis) -> packed raw outputs [..., 24]. On CUDA tensors one
    kernel launch each way for all scenes, no fallback; on CPU tensors the
    plain version with each scene's heads on its rows."""
    if cfg.human_light and human_poses is None:
        raise ValueError("human_light shading needs human_poses")
    if points.device.type == "cpu":
        return shader_raw_plain(params, cfg, points, normals, view_dirs, feats, human_poses,
                                head=scene_heads(n_scenes))
    if not supported(cfg):
        raise NotImplementedError(
            f"the shader kernel needs 256 feats, ide_deg <= 5 and light_pos_freq "
            f"0-{MAX_LIGHT_PE}; got {cfg}")
    geo, feats2d, spec, ws, bs = kernel_inputs(params, cfg, points, normals, view_dirs, feats,
                                               human_poses)
    n = geo.shape[0] // n_scenes
    out = _ShaderScenesFn.apply(geo.view(n_scenes, n, -1), feats2d.view(n_scenes, n, HID),
                                spec, *ws, *bs)
    return out.reshape(*points.shape[:-1], OUT)


def kernel_inputs(params, cfg, points, normals, view_dirs, feats, human_poses=None):
    """What the kernel reads, from the shader's arguments: (geo [n, 9 or 21],
    feats [n, 256], spec, resolved weights, biases) in head order."""
    shape = points.shape[:-1]
    n = int(np.prod(shape))
    cols = [points.reshape(n, 3), normals.reshape(n, 3), view_dirs.reshape(n, 3)]
    if cfg.human_light:
        poses = human_poses.detach().expand(*shape, 3, 4).reshape(n, 3, 4)
        cols += [poses[:, :, :3].reshape(n, 9), poses[:, :, 3]]
    geo = torch.cat(cols, -1).float().contiguous()
    heads = head_order(cfg)
    layers = resolve_weight_norm(params)
    ws = [l["w"] for name in heads for l in layers[name]]
    bs = [l["b"] for name in heads for l in layers[name]]
    pads, dims = head_pad(cfg), head_dims(cfg)
    spec = (int(cfg.sphere_direction), int(cfg.human_light),
            tuple(pads[h] for h in heads), tuple(dims[h] for h in heads), encodings(cfg))
    return geo, feats.reshape(n, HID).float().contiguous(), spec, ws, bs


def shader_raw(params, cfg, points, normals, view_dirs, feats, human_poses=None) -> torch.Tensor:
    """Packed raw outputs [..., 24]: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Gradients flow to every head's
    parameters, the points, normals, view directions and feats; the human
    poses [..., 3, 4] (needed when cfg.human_light) are data."""
    if cfg.human_light and human_poses is None:
        raise ValueError("human_light shading needs human_poses")
    if points.device.type == "cpu":
        return shader_raw_plain(params, cfg, points, normals, view_dirs, feats, human_poses)
    if not supported(cfg):
        raise NotImplementedError(
            f"the shader kernel needs 256 feats, ide_deg <= 5 and light_pos_freq "
            f"0-{MAX_LIGHT_PE}; got {cfg}")
    geo, feats2d, spec, ws, bs = kernel_inputs(params, cfg, points, normals, view_dirs, feats,
                                               human_poses)
    out = _ShaderFn.apply(geo, feats2d, spec, *ws, *bs)
    return out.reshape(*points.shape[:-1], OUT)


# ---------------------------------------------------------------------------
# the least work the function needs (for the bound beside the kernel time)
# ---------------------------------------------------------------------------


def flops_per_row(cfg) -> float:
    """Head products at their true widths (the outer-light head runs twice)."""
    dims = head_dims(cfg)
    total = 0
    for name in head_order(cfg):
        d_in, d_out = dims[name]
        kn = d_in * HID + 2 * HID * HID + HID * d_out
        total += kn * (2 if name == "outer_light" else 1)
    return 2.0 * total


def flops(n: int, cfg, backward: bool = False) -> float:
    """Forward; the backward recomputes it, then the input-cotangent and
    weight-gradient products (3x)."""
    return n * flops_per_row(cfg) * (3 if backward else 1)


def min_bytes(n: int, cfg, backward: bool = False) -> float:
    """Each input read once, each output written once (f32 rows, bf16
    weights, f32 weight gradients)."""
    heads = head_order(cfg)
    w = weight_elems([head_pad(cfg)[h] for h in heads])
    geo = geo_width(cfg)
    if backward:
        return n * (geo + HID + OUT) * 4 + n * (DGEO + HID) * 4 + w * 2 + w * 4
    return n * (geo + HID) * 4 + w * 2 + n * OUT * 4
