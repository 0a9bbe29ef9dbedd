"""Positional encoding and Ref-NeRF integrated directional encoding (IDE).

Counterpart of nero_tpu/utils/encodings.py:26-162: PE with identity channels
first, then [sin(2^i x), cos(2^i x)] per octave; IDE with the z-Vandermonde
coefficient table and the de-Moivre recurrence for (x + iy)^m; and the
mip-NeRF integrated positional encoding (IPE) of the Stage-II human light.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


def positional_encode(x: torch.Tensor, num_freqs: int,
                      include_input: bool = True) -> torch.Tensor:
    outs = [x] if include_input else []
    for i in range(num_freqs):
        freq = 2.0 ** i
        outs.append(torch.sin(x * freq))
        outs.append(torch.cos(x * freq))
    return torch.cat(outs, dim=-1)


def positional_encode_dim(d: int, num_freqs: int, include_input: bool = True) -> int:
    return (d if include_input else 0) + 2 * d * num_freqs


def _generalized_binomial(a: float, k: int) -> float:
    out = 1.0
    for i in range(k):
        out *= a - i
    return out / math.factorial(k)


def _assoc_legendre_coeff(l: int, m: int, k: int) -> float:
    return ((-1) ** m * 2 ** l * math.factorial(l) / math.factorial(k)
            / math.factorial(l - k - m)
            * _generalized_binomial(0.5 * (l + k + m - 1.0), l))


def _sph_harm_coeff(l: int, m: int, k: int) -> float:
    return (math.sqrt((2.0 * l + 1.0) * math.factorial(l - m)
                      / (4.0 * math.pi * math.factorial(l + m)))
            * _assoc_legendre_coeff(l, m, k))


@lru_cache(maxsize=None)
def ide_tables(deg_view: int):
    """(m per entry [n_ml] int32, sigma [n_ml], coefficient matrix
    [l_max+1, n_ml] float32, l_max) — the tables of `_ide_tables`."""
    if deg_view > 5:
        raise ValueError("IDE deg_view > 5 is numerically unstable")
    ml_list = []
    for i in range(deg_view):
        l = 2 ** i
        for m in range(l + 1):
            ml_list.append((m, l))
    l_max = 2 ** (deg_view - 1)
    mat = np.zeros((l_max + 1, len(ml_list)), dtype=np.float64)
    for i, (m, l) in enumerate(ml_list):
        for k in range(l - m + 1):
            mat[k, i] = _sph_harm_coeff(l, m, k)
    m_arr = np.array([m for m, _ in ml_list], dtype=np.int32)
    l_arr = np.array([l for _, l in ml_list], dtype=np.float32)
    sigma = 0.5 * l_arr * (l_arr + 1.0)
    return m_arr, sigma, mat.astype(np.float32), l_max


@lru_cache(maxsize=None)
def _ide_device_tables(deg_view: int, device: torch.device, dtype: torch.dtype):
    """(coefficient matrix, sigma) on `device`: made once, so that no call
    pays a host-to-device copy."""
    _, sigma_np, mat_np, _ = ide_tables(deg_view)
    return (torch.as_tensor(mat_np, dtype=dtype, device=device),
            torch.as_tensor(sigma_np, dtype=dtype, device=device))


@lru_cache(maxsize=None)
def ide_kernel_table(deg_view: int) -> np.ndarray:
    """The IDE table of degree `deg_view` as csrc/encode.cuh reads it, f32:
    the coefficient matrix [l_max + 1, n_ml] row-major, then sigma [n_ml],
    then m [n_ml]."""
    m_arr, sigma, mat, _ = ide_tables(deg_view)
    return np.concatenate([mat.reshape(-1), sigma, m_arr.astype(np.float32)]).astype(np.float32)


def ide_dim(deg_view: int) -> int:
    return 2 * len(ide_tables(deg_view)[0])


def integrated_dir_encode(xyz: torch.Tensor, kappa_inv, deg_view: int = 5) -> torch.Tensor:
    """xyz [..., 3] unit directions, kappa_inv [..., 1] or scalar ->
    [..., 2 * n_ml] = [Re(ide), Im(ide)]."""
    m_arr, _, _, l_max = ide_tables(deg_view)
    mat, sigma = _ide_device_tables(deg_view, xyz.device, xyz.dtype)
    x, y, z = xyz[..., 0:1], xyz[..., 1:2], xyz[..., 2:3]

    vmz = torch.cat([z ** i for i in range(l_max + 1)], dim=-1)
    pz = vmz @ mat

    res, ims = [torch.ones_like(x)], [torch.zeros_like(x)]
    for _ in range(int(m_arr.max())):
        re_p, im_p = res[-1], ims[-1]
        res.append(re_p * x - im_p * y)
        ims.append(re_p * y + im_p * x)
    # one column per (m, l) entry, picked by concatenation: its backward is
    # plain slicing, where a tensor index would sort and scatter
    re_m = torch.cat([res[m] for m in m_arr], dim=-1)
    im_m = torch.cat([ims[m] for m in m_arr], dim=-1)

    atten = torch.exp(-sigma * kappa_inv)   # a Python scalar makes no device tensor
    return torch.cat([re_m * pz * atten, im_m * pz * atten], dim=-1)


def expected_sin(mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """E[sin(x)] for x ~ N(mean, var)."""
    return torch.exp(-0.5 * var) * torch.sin(mean)


@lru_cache(maxsize=None)
def _ipe_scales(min_deg: int, max_deg: int, device: torch.device, dtype: torch.dtype):
    """2^min_deg ... 2^(max_deg-1) on `device`: made once, so that no call
    copies from the host (a copy that a CUDA graph's capture refuses)."""
    return torch.tensor([2.0 ** i for i in range(min_deg, max_deg)], dtype=dtype,
                        device=device)


def integrated_pos_encode(mean: torch.Tensor, var: torch.Tensor, min_deg: int,
                          max_deg: int) -> torch.Tensor:
    """mip-NeRF IPE over a diagonal Gaussian; output dim = 2*d*(max_deg-min_deg)."""
    scales = _ipe_scales(min_deg, max_deg, mean.device, mean.dtype)
    shape = mean.shape[:-1] + (len(scales) * mean.shape[-1],)  # also with no rows
    scaled_mean = (mean[..., None, :] * scales[:, None]).reshape(shape)
    scaled_var = (var[..., None, :] * scales[:, None] ** 2).reshape(shape)
    return expected_sin(torch.cat([scaled_mean, scaled_mean + 0.5 * math.pi], dim=-1),
                        torch.cat([scaled_var, scaled_var], dim=-1))
