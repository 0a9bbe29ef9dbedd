"""Split-sum environment-BRDF lookup table (the "FG LUT").

Counterpart of nero_tpu/ops/fg_lut.py: the 256x256x2 table [roughness rows,
NoV cols, (scale A, bias B)] is read from `assets/bsdf_256_256.bin` when it
is present, else integrated on the host by GGX importance sampling; the
lookup is a clamped bilinear gather with texel centres at (i + 0.5) / 256.
"""
from __future__ import annotations

import os

import numpy as np
import torch

LUT_RES = 256
DEFAULT_LUT_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets", "bsdf_256_256.bin")


def _hammersley(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.uint32)
    bits = i.copy()
    bits = ((bits << 16) | (bits >> 16)) & 0xFFFFFFFF
    bits = (((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)) & 0xFFFFFFFF
    bits = (((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)) & 0xFFFFFFFF
    bits = (((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)) & 0xFFFFFFFF
    bits = (((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)) & 0xFFFFFFFF
    return np.stack([i.astype(np.float64) / n,
                     bits.astype(np.float64) * 2.3283064365386963e-10], -1)


def compute_fg_lut(res: int = LUT_RES, n_samples: int = 1024) -> np.ndarray:
    """Integrate the environment BRDF over GGX-importance-sampled half vectors."""
    nov = np.clip((np.arange(res, dtype=np.float64) + 0.5) / res, 1e-4, 1.0)
    rough = (np.arange(res, dtype=np.float64) + 0.5) / res
    NoV = nov[None, :]
    a = (rough ** 2)[:, None]
    k_ibl = a / 2.0
    Vx = np.sqrt(1.0 - NoV ** 2)
    Vz = NoV
    xi = _hammersley(n_samples)
    A = np.zeros((res, res), dtype=np.float64)
    B = np.zeros((res, res), dtype=np.float64)
    for s in range(n_samples):
        x1, x2 = xi[s]
        phi = 2.0 * np.pi * x1
        cos_t = np.sqrt((1.0 - x2) / (1.0 + (a ** 2 - 1.0) * x2))
        sin_t = np.sqrt(np.maximum(1.0 - cos_t ** 2, 0.0))
        Hx = np.cos(phi) * sin_t
        Hz = cos_t
        VoH = Vx * Hx + Vz * Hz
        NoL = 2.0 * VoH * Hz - Vz
        NoH = np.broadcast_to(Hz, VoH.shape)
        valid = NoL > 0
        VoH_c = np.clip(VoH, 0.0, 1.0)
        NoL_c = np.clip(NoL, 1e-6, 1.0)
        NoH_c = np.clip(NoH, 1e-6, 1.0)
        G = (NoL_c / (NoL_c * (1 - k_ibl) + k_ibl)) * (NoV / (NoV * (1 - k_ibl) + k_ibl))
        G_vis = G * VoH_c / (NoH_c * NoV)
        Fc = (1.0 - VoH_c) ** 5
        A += np.where(valid, (1.0 - Fc) * G_vis, 0.0)
        B += np.where(valid, Fc * G_vis, 0.0)
    return (np.stack([A, B], axis=-1) / n_samples).astype(np.float32)


def get_fg_lut(cache_path: str | None = DEFAULT_LUT_PATH) -> np.ndarray:
    """Read the LUT from `cache_path` if present, else compute (and cache) it."""
    if cache_path and os.path.exists(cache_path):
        data = np.fromfile(cache_path, dtype=np.float32)
        if data.size == LUT_RES * LUT_RES * 2:
            return data.reshape(LUT_RES, LUT_RES, 2)
    lut = compute_fg_lut()
    if cache_path:
        os.makedirs(os.path.dirname(os.path.abspath(cache_path)), exist_ok=True)
        tmp = f"{cache_path}.{os.getpid()}.tmp"   # atomic: readers never see a partial file
        lut.tofile(tmp)
        os.replace(tmp, cache_path)
    return lut


def fg_lookup(lut: torch.Tensor, nov: torch.Tensor, roughness: torch.Tensor) -> torch.Tensor:
    """Bilinear clamped sample. lut [R,R,2]; nov, roughness [...,1] -> [...,2]."""
    res = lut.shape[0]
    u = torch.clamp(nov[..., 0], 0.0, 1.0) * res - 0.5
    v = torch.clamp(roughness[..., 0], 0.0, 1.0) * res - 0.5
    u0 = torch.clamp(torch.floor(u), 0, res - 1)
    v0 = torch.clamp(torch.floor(v), 0, res - 1)
    u1 = torch.clamp(u0 + 1, 0, res - 1)
    v1 = torch.clamp(v0 + 1, 0, res - 1)
    fu = torch.clamp(u - u0, 0.0, 1.0)[..., None]
    fv = torch.clamp(v - v0, 0.0, 1.0)[..., None]
    u0i, u1i, v0i, v1i = u0.long(), u1.long(), v0.long(), v1.long()
    top = lut[v0i, u0i] * (1 - fu) + lut[v0i, u1i] * fu
    bot = lut[v1i, u0i] * (1 - fu) + lut[v1i, u1i] * fu
    return top * (1 - fv) + bot * fv
