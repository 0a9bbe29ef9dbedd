"""Whole Stage-I shader (six heads + IDE/PE encodings): CUDA kernel and
its plain version.

Replaces nero_tpu/ops/pallas/shader_kernel.py::shader_fused_raw (:552),
whose pallas_calls are nero_shader_fwd_f* (:467) and nero_shader_bwd_f*
(:494), in the default variant. The kernel source is csrc/shader.cu; its
header comment gives the design, including the hand-derived backward that
replaces the in-kernel jax.vjp. `shader_raw` launches the kernel for CUDA
tensors and runs `shader_raw_plain` (plain torch, autograd) for CPU tensors,
and only then. The activations, the FG-LUT lookup and sRGB stay outside the
kernel (fields/app_shading.py), as on the TPU.

What bounds it on the card: tensor-core operations (`flops`), about 0.17 ms
forward and 0.5 ms backward at N = 65,536 and 989 TFLOP/s; the bytes it
must move (geometry and feats in, 24 raw channels out) are ~75 MB, 0.02 ms.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from nero_tpu_torch.ops import cuda_build
from nero_tpu_torch.ops.mlp import predictor_raw, resolve_weight_norm
from nero_tpu_torch.utils.encodings import (ide_dim, ide_tables, integrated_dir_encode,
                                            positional_encode, positional_encode_dim)

TILE = 64
HID = 256
OUT = 24
GEO = 9
HEAD_ORDER = ("metallic", "roughness", "albedo", "outer_light", "inner_light",
              "inner_weight")
# padded input width and output count per head (csrc/shader.cu head_di)
HEAD_PAD = {"metallic": (272, 1), "roughness": (272, 1), "albedo": (272, 3),
            "outer_light": (80, 3), "inner_light": (128, 3), "inner_weight": (96, 1)}
DO = 16

launches = {"shader_fwd": 0, "shader_bwd": 0}


def supported(cfg) -> bool:
    return (not cfg.sphere_direction and not cfg.human_light and cfg.feats_dim == HID
            and cfg.ide_deg == 5 and cfg.light_pos_freq == 8)


def head_dims(cfg) -> dict:
    """Unpadded (d_in, d_out) per head."""
    sph = ide_dim(cfg.ide_deg)
    pos = positional_encode_dim(3, cfg.light_pos_freq)
    ref = positional_encode_dim(3, 6)
    f = cfg.feats_dim
    return {"metallic": (f + 3, 1), "roughness": (f + 3, 1), "albedo": (f + 3, 3),
            "outer_light": (sph * (2 if cfg.sphere_direction else 1), 3),
            "inner_light": (pos + sph, 3), "inner_weight": (pos + ref, 1)}


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)


def unpack_raw(out: torch.Tensor) -> dict:
    """Packed [..., 24] -> named raw outputs (shader_kernel.py:262-265)."""
    return {"metallic_z": out[..., 0:1], "roughness_z": out[..., 1:2],
            "albedo_z": out[..., 2:5], "diffuse_light_z": out[..., 5:8],
            "direct_light_z": out[..., 8:11], "inner_light_z": out[..., 11:14],
            "occ_z": out[..., 14:15], "reflective": out[..., 15:18], "NoV": out[..., 18:19]}


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def shader_raw_plain(params, cfg, points, normals, view_dirs, feats) -> torch.Tensor:
    """Packed raw outputs [..., 24] in plain torch (default variant)."""
    normals = _normalize(normals)
    view_dirs = _normalize(view_dirs)
    nov = torch.sum(view_dirs * normals, -1, keepdim=True)
    reflective = nov * normals * 2 - view_dirs
    x_mat = torch.cat([feats, points], -1)
    metallic_z = predictor_raw(params["metallic"], x_mat)
    roughness_z = predictor_raw(params["roughness"], x_mat)
    albedo_z = predictor_raw(params["albedo"], x_mat)
    ide_n = integrated_dir_encode(normals, torch.ones_like(points[..., :1]), cfg.ide_deg)
    diffuse_z = predictor_raw(params["outer_light"], ide_n)
    ide_r = integrated_dir_encode(reflective, torch.sigmoid(roughness_z), cfg.ide_deg)
    direct_z = predictor_raw(params["outer_light"], ide_r)
    pe_pts = positional_encode(points, cfg.light_pos_freq)
    inner_z = predictor_raw(params["inner_light"], torch.cat([pe_pts, ide_r], -1))
    occ_in = torch.cat([pe_pts, positional_encode(reflective, 6)], -1).detach()
    occ_z = predictor_raw(params["inner_weight"], occ_in)
    pad = torch.zeros(points.shape[:-1] + (OUT - 19,), dtype=points.dtype,
                      device=points.device)
    return torch.cat([metallic_z, roughness_z, albedo_z, diffuse_z, direct_z, inner_z,
                      occ_z, reflective, nov, pad], -1)


# ---------------------------------------------------------------------------
# kernel plumbing
# ---------------------------------------------------------------------------


def _lib():
    lib = cuda_build.load("shader")
    if not getattr(lib, "_nero_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.shader_weight_elems.restype = ctypes.c_size_t
        lib.shader_weight_elems.argtypes = []
        lib.shader_tile.restype = i
        lib.shader_tile.argtypes = []
        lib.shader_scratch_elems.restype = ctypes.c_size_t
        lib.shader_scratch_elems.argtypes = [i]
        lib.shader_part_elems.restype = ctypes.c_size_t
        lib.shader_part_elems.argtypes = [i]
        lib.shader_fwd.restype = i
        lib.shader_fwd.argtypes = [vp, vp, i, vp, vp, vp, vp, vp]
        lib.shader_bwd.restype = i
        lib.shader_bwd.argtypes = [vp, vp, i, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp]
        if lib.shader_tile() != TILE or lib.shader_weight_elems() != _W_TOTAL:
            raise RuntimeError("csrc/shader.cu layout differs from ops/shader.py")
        lib._nero_typed = True
    return lib


def _head_shapes(name):
    di, _ = HEAD_PAD[name]
    return ((di, HID), (HID, HID), (HID, HID), (HID, DO))


_W_TOTAL = sum(r * c for n in HEAD_ORDER for r, c in _head_shapes(n))


def pack_weights(ws, bs):
    """24 resolved weights / biases (4 per head, HEAD_ORDER) -> (packed bf16,
    bias f32 [6, 4, 256]) in the kernel layout."""
    parts = []
    bias = torch.zeros(6, 4, HID, dtype=torch.float32, device=ws[0].device)
    for h, name in enumerate(HEAD_ORDER):
        for l, (r, c) in enumerate(_head_shapes(name)):
            w = ws[4 * h + l]
            parts.append(F.pad(w, (0, c - w.shape[1], 0, r - w.shape[0])).reshape(-1))
            b = bs[4 * h + l]
            bias[h, l, :b.shape[0]] = b
    return torch.cat(parts).to(torch.bfloat16).contiguous(), bias


def unpack_grads(dW: torch.Tensor, dB: torch.Tensor, dims: dict):
    dws, dbs = [], []
    sizes = [r * c for n in HEAD_ORDER for r, c in _head_shapes(n)]
    chunks = torch.split(dW, sizes)
    for h, name in enumerate(HEAD_ORDER):
        d_in, d_out = dims[name]
        for l, (r, c) in enumerate(_head_shapes(name)):
            g = chunks[4 * h + l].view(r, c)
            rows = d_in if l == 0 else HID
            cols = d_out if l == 3 else HID
            dws.append(g[:rows, :cols])
            dbs.append(dB[h, l, :cols])
    return dws, dbs


_IDE_TABLES: dict = {}


def ide_table_on(device) -> torch.Tensor:
    """IDE coefficient table (mat, sigma, m) on `device`, copied there once:
    a host-to-device copy per call would stall the host on the stream."""
    key = str(device)
    if key not in _IDE_TABLES:
        m_arr, sigma, mat, _ = ide_tables(5)
        tab = np.concatenate([mat.reshape(-1), sigma, m_arr.astype(np.float32)])
        _IDE_TABLES[key] = torch.as_tensor(tab, dtype=torch.float32, device=device)
    return _IDE_TABLES[key]


class _ShaderFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, geo, feats, dims, *wb):
        n = geo.shape[0]
        W, B = pack_weights(wb[:24], wb[24:])
        tab = ide_table_on(geo.device)
        out = torch.empty(n, OUT, device=geo.device)
        rc = _lib().shader_fwd(geo.data_ptr(), feats.data_ptr(), n, W.data_ptr(),
                               B.data_ptr(), tab.data_ptr(), out.data_ptr(),
                               torch.cuda.current_stream(geo.device).cuda_stream)
        cuda_build.check(rc, "shader_fwd")
        launches["shader_fwd"] += 1
        ctx.save_for_backward(geo, feats, W, B, tab)
        ctx.dims = dims
        return out

    @staticmethod
    def backward(ctx, gout):
        geo, feats, W, B, tab = ctx.saved_tensors
        n = geo.shape[0]
        dev = geo.device
        lib = _lib()
        m_rows = -(-n // TILE) * TILE
        scratch = torch.empty(lib.shader_scratch_elems(m_rows), dtype=torch.bfloat16,
                              device=dev)
        part = torch.empty(lib.shader_part_elems(m_rows), device=dev)
        dgeo = torch.empty(n, GEO, device=dev)
        dfeats = torch.empty(n, HID, device=dev)
        dW = torch.empty(W.numel(), device=dev)
        dB = torch.zeros(6, 4, HID, device=dev)
        gout = gout.float().contiguous()
        rc = lib.shader_bwd(geo.data_ptr(), feats.data_ptr(), n, W.data_ptr(), B.data_ptr(),
                            tab.data_ptr(), gout.data_ptr(), dgeo.data_ptr(),
                            dfeats.data_ptr(), scratch.data_ptr(), part.data_ptr(),
                            dW.data_ptr(), dB.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check(rc, "shader_bwd")
        launches["shader_bwd"] += 1
        dws, dbs = unpack_grads(dW, dB, ctx.dims)
        return (dgeo, dfeats, None, *dws, *dbs)


def shader_raw(params, cfg, points, normals, view_dirs, feats) -> torch.Tensor:
    """Packed raw outputs [..., 24]: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Gradients flow to every head's
    parameters, the points, normals, view directions and feats."""
    if points.device.type == "cpu":
        return shader_raw_plain(params, cfg, points, normals, view_dirs, feats)
    if not supported(cfg):
        raise NotImplementedError(
            "the shader kernel implements the default variant only (no sphere_direction, "
            f"no human_light, 256 feats, IDE deg 5, light PE 8); got {cfg}")
    shape = points.shape[:-1]
    n = int(np.prod(shape))
    geo = torch.cat([points.reshape(n, 3), normals.reshape(n, 3),
                     view_dirs.reshape(n, 3)], -1).float().contiguous()
    layers = resolve_weight_norm(params)
    ws = [l["w"] for name in HEAD_ORDER for l in layers[name]]
    bs = [l["b"] for name in HEAD_ORDER for l in layers[name]]
    out = _ShaderFn.apply(geo, feats.reshape(n, HID).float().contiguous(), head_dims(cfg),
                          *ws, *bs)
    return out.reshape(*shape, OUT)


# ---------------------------------------------------------------------------
# the least work the function needs (for the bound beside the kernel time)
# ---------------------------------------------------------------------------


def flops_per_row(cfg) -> float:
    """Head products at their true widths (the outer-light head runs twice)."""
    dims = head_dims(cfg)
    total = 0
    for name in HEAD_ORDER:
        d_in, d_out = dims[name]
        kn = d_in * HID + 2 * HID * HID + HID * d_out
        total += kn * (2 if name == "outer_light" else 1)
    return 2.0 * total


def flops(n: int, cfg, backward: bool = False) -> float:
    """Forward; the backward recomputes it, then the input-cotangent and
    weight-gradient products (3x)."""
    return n * flops_per_row(cfg) * (3 if backward else 1)


def min_bytes(n: int, backward: bool = False) -> float:
    w = _W_TOTAL
    if backward:
        return n * (GEO + HID + OUT) * 4 + n * (GEO + HID) * 4 + w * 2 + w * 4
    return n * (GEO + HID) * 4 + w * 2 + n * OUT * 4
