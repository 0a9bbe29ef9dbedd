"""Positional encoding, Ref-NeRF's integrated directional encoding (IDE)
and mip-NeRF's integrated positional encoding (IPE), plain torch."""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


def positional_encode(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(F-1) x), cos(2^(F-1) x)]."""
    outs = [x]
    for i in range(num_freqs):
        outs.append(torch.sin(x * 2.0 ** i))
        outs.append(torch.cos(x * 2.0 ** i))
    return torch.cat(outs, dim=-1)


def pe_dim(d: int, num_freqs: int) -> int:
    return d + 2 * d * num_freqs


def _sph_harm_coeff(l: int, m: int, k: int) -> float:
    binom = 1.0
    a = 0.5 * (l + k + m - 1.0)
    for i in range(l):
        binom *= a - i
    binom /= math.factorial(l)
    legendre = ((-1) ** m * 2 ** l * math.factorial(l) / math.factorial(k)
                / math.factorial(l - k - m) * binom)
    return (math.sqrt((2.0 * l + 1.0) * math.factorial(l - m)
                      / (4.0 * math.pi * math.factorial(l + m))) * legendre)


@lru_cache(maxsize=None)
def ide_tables(deg: int):
    """(m per entry, sigma per entry, z-Vandermonde coefficients [l_max+1, n], l_max)."""
    ml = [(m, 2 ** i) for i in range(deg) for m in range(2 ** i + 1)]
    l_max = 2 ** (deg - 1)
    mat = np.zeros((l_max + 1, len(ml)))
    for i, (m, l) in enumerate(ml):
        for k in range(l - m + 1):
            mat[k, i] = _sph_harm_coeff(l, m, k)
    ls = np.array([l for _, l in ml], np.float32)
    return (tuple(m for m, _ in ml), (0.5 * ls * (ls + 1.0)).astype(np.float32),
            mat.astype(np.float32), l_max)


def ide_dim(deg: int) -> int:
    return 2 * len(ide_tables(deg)[0])


def integrated_dir_encode(xyz: torch.Tensor, kappa_inv, deg: int) -> torch.Tensor:
    """Unit directions [..., 3], kappa_inv [..., 1] -> [..., 2n] = [Re, Im]."""
    ms, sigma, mat, l_max = ide_tables(deg)
    mat = torch.as_tensor(mat, device=xyz.device)
    sigma = torch.as_tensor(sigma, device=xyz.device)
    x, y, z = xyz[..., 0:1], xyz[..., 1:2], xyz[..., 2:3]
    pz = torch.cat([z ** i for i in range(l_max + 1)], dim=-1) @ mat
    res, ims = [torch.ones_like(x)], [torch.zeros_like(x)]
    for _ in range(max(ms)):
        re_p, im_p = res[-1], ims[-1]
        res.append(re_p * x - im_p * y)
        ims.append(re_p * y + im_p * x)
    re_m = torch.cat([res[m] for m in ms], dim=-1)
    im_m = torch.cat([ims[m] for m in ms], dim=-1)
    atten = torch.exp(-sigma * kappa_inv)
    return torch.cat([re_m * pz * atten, im_m * pz * atten], dim=-1)


def integrated_pos_encode(mean: torch.Tensor, var: torch.Tensor, min_deg: int,
                          max_deg: int) -> torch.Tensor:
    """E[sin] of each octave of a diagonal Gaussian: [..., 2 d (max - min)]."""
    scales = torch.tensor([2.0 ** i for i in range(min_deg, max_deg)], dtype=mean.dtype,
                          device=mean.device)
    shape = mean.shape[:-1] + (len(scales) * mean.shape[-1],)
    m = (mean[..., None, :] * scales[:, None]).reshape(shape)
    v = (var[..., None, :] * scales[:, None] ** 2).reshape(shape)
    m2, v2 = torch.cat([m, m + 0.5 * math.pi], dim=-1), torch.cat([v, v], dim=-1)
    return torch.exp(-0.5 * v2) * torch.sin(m2)
