"""Inverse-CDF importance sampling along rays (deterministic mid-quantiles).

Counterpart of nero_tpu/ops/sample_pdf.py with `key=None`: every caller on
the Stage-I path samples deterministically.
"""
from __future__ import annotations

import torch


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int) -> torch.Tensor:
    """bins [..., B] ascending edges, weights [..., B-1] -> [..., n_samples]."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)

    u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                       dtype=cdf.dtype, device=cdf.device)
    u = u.expand(cdf.shape[:-1] + (n_samples,)).contiguous()
    # searchsorted(side='right')
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)

    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)
