"""SDF field: 8x256 weight-norm MLP with geometric sphere initialisation.

Counterpart of nero_tpu/fields/sdf.py: PE(6) on xyz with identity channels
first, softplus(beta=100), skip concat / sqrt(2) before layer `skip`, a
257-d output (sdf + 256-d feature). `sdf_value` is plain torch on every
device (nero_tpu computes it outside Pallas by default). The SDF with its
spatial gradient lives in ops/sdf_grad.py beside its CUDA kernel.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from nero_tpu_torch.ops.mlp import apply_dense, init_dense, normal_weight, softplus_beta
from nero_tpu_torch.utils.encodings import positional_encode, positional_encode_dim


class SDFConfig(NamedTuple):
    d_in: int = 3
    d_out: int = 257
    d_hidden: int = 256
    n_layers: int = 8
    skip: int = 4
    multires: int = 6
    bias: float = 0.5
    scale: float = 1.0
    geometric_init: bool = True
    weight_norm: bool = True
    beta: float = 100.0


def _dims(cfg: SDFConfig):
    d0 = positional_encode_dim(cfg.d_in, cfg.multires) if cfg.multires > 0 else cfg.d_in
    return [d0] + [cfg.d_hidden] * cfg.n_layers + [cfg.d_out]


def init_sdf(gen: torch.Generator, cfg: SDFConfig = SDFConfig(), device="cpu"):
    dims = _dims(cfg)
    n_lin = len(dims) - 1
    layers = []
    for l in range(n_lin):
        d_in_l = dims[l]
        d_out_l = dims[l + 1] - dims[0] if l + 1 == cfg.skip else dims[l + 1]
        if not cfg.geometric_init:
            layers.append(init_dense(gen, d_in_l, d_out_l, weight_norm=cfg.weight_norm,
                                     device=device))
            continue
        b = torch.zeros(d_out_l)
        if l == n_lin - 1:
            w = normal_weight(gen, d_in_l, d_out_l,
                              mean=math.sqrt(math.pi) / math.sqrt(d_in_l), std=1e-4)
            b = torch.full((d_out_l,), -cfg.bias)
        else:
            w = normal_weight(gen, d_in_l, d_out_l, std=math.sqrt(2.0) / math.sqrt(d_out_l))
            if cfg.multires > 0 and l == 0:
                w[cfg.d_in:, :] = 0.0
            elif cfg.multires > 0 and l == cfg.skip:
                w[-(dims[0] - cfg.d_in):, :] = 0.0
        layers.append(init_dense(gen, d_in_l, d_out_l, weight_norm=cfg.weight_norm,
                                 weight=w, bias=b, device=device))
    return layers


def sdf_apply(params, x: torch.Tensor, cfg: SDFConfig = SDFConfig()) -> torch.Tensor:
    """[..., 3] -> [..., d_out] (sdf first, then features). `params` may be
    {v,g,b} or resolved {w,b} layers."""
    x = x * cfg.scale
    inputs = positional_encode(x, cfg.multires) if cfg.multires > 0 else x
    h = inputs
    n_lin = len(params)
    for l in range(n_lin):
        if l == cfg.skip:
            h = torch.cat([h, inputs], dim=-1) / math.sqrt(2.0)
        h = apply_dense(params[l], h)
        if l < n_lin - 1:
            h = softplus_beta(h, cfg.beta)
    return h


def sdf_value(params, x: torch.Tensor, cfg: SDFConfig = SDFConfig()) -> torch.Tensor:
    """[..., 3] -> [..., 1] signed distance."""
    return sdf_apply(params, x, cfg)[..., :1]
