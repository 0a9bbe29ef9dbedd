"""SDF field: 8x256 weight-norm MLP with geometric sphere initialisation.

Counterpart of nero_tpu/fields/sdf.py: PE(6) on xyz with identity channels
first, softplus(beta=100), skip concat / sqrt(2) before layer `skip`, a
257-d output (sdf + 256-d feature). `sdf_value` is plain torch on every
device (nero_tpu computes it outside Pallas by default). Hidden activations
take the storage dtype of ops/mlp.py's context at nero_tpu's points
(fields/sdf.py:87-100). `sdf_apply_fwd` carries the forward-mode tangents
of the sdf along the three axes beside the forward (nero_tpu's
`jax.linearize` and three basis tangents, fields/sdf.py:118-122). The SDF
with its spatial gradient lives in ops/sdf_grad.py beside its CUDA kernel.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from nero_tpu_torch.ops.mlp import (apply_dense, cast_hidden, dense_product, init_dense,
                                    normal_weight, resolve_weight_norm, softplus_beta)
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


@functools.cache
def _sqrt2(dtype: torch.dtype) -> float:
    """The skip's divisor sqrt(2) in the activations' dtype: nero_tpu divides
    by a Python float, which JAX takes in the array's dtype, so under bf16
    storage the divisor is sqrt(2) rounded to bf16 (1.4140625)."""
    return float(torch.tensor(math.sqrt(2.0), dtype=dtype))


def sdf_apply(params, x: torch.Tensor, cfg: SDFConfig = SDFConfig()) -> torch.Tensor:
    """[..., 3] -> [..., d_out] (sdf first, then features). `params` may be
    {v,g,b} or resolved {w,b} layers."""
    x = x * cfg.scale
    inputs = positional_encode(x, cfg.multires) if cfg.multires > 0 else x
    h = cast_hidden(inputs)
    n_lin = len(params)
    for l in range(n_lin):
        if l == cfg.skip:
            h = cast_hidden(torch.cat([h, cast_hidden(inputs)], dim=-1) / _sqrt2(h.dtype))
        h = apply_dense(params[l], h)
        if l < n_lin - 1:
            h = cast_hidden(softplus_beta(h, cfg.beta))
    return h


def _encode_tangents(x: torch.Tensor, cfg: SDFConfig):
    """(the input encoding of x * scale, its derivatives along the three
    axes [..., 3, d0]) by torch.func.jvp, as JAX's jvp forms them."""
    def encode(p):
        p = p * cfg.scale
        return positional_encode(p, cfg.multires) if cfg.multires > 0 else p

    basis = torch.eye(3, dtype=x.dtype, device=x.device)
    tans = [torch.func.jvp(encode, (x,), (basis[i].expand_as(x),))[1] for i in range(3)]
    return encode(x), torch.stack(tans, dim=-2)


def sdf_apply_fwd(params, x: torch.Tensor, cfg: SDFConfig = SDFConfig()):
    """(sdf_apply(params, x) [..., d_out], d sdf / dx [..., 3]) by forward-mode
    tangents along the three axes, stored and multiplied as the forward is.
    Plain tensor ops throughout, so the training gradient reaches the
    weights through the tangents too. x carries no gradient."""
    layers = resolve_weight_norm(params)
    inputs, inputs_t = _encode_tangents(x, cfg)
    h, t = cast_hidden(inputs), cast_hidden(inputs_t)
    n_lin = len(layers)
    for l, layer in enumerate(layers):
        if l == cfg.skip:
            h = cast_hidden(torch.cat([h, cast_hidden(inputs)], dim=-1) / _sqrt2(h.dtype))
            t = cast_hidden(torch.cat([t, cast_hidden(inputs_t)], dim=-1) / _sqrt2(t.dtype))
        w = layer["w"]
        z = dense_product(h, w) + layer["b"]
        if l == n_lin - 1:
            # only the sdf column's tangent is the gradient
            grad = dense_product(t, w[:, :1])[..., 0]
            return z, grad
        h = cast_hidden(softplus_beta(z, cfg.beta))
        t = cast_hidden(torch.sigmoid(cfg.beta * z)[..., None, :] * dense_product(t, w))


def sdf_value(params, x: torch.Tensor, cfg: SDFConfig = SDFConfig()) -> torch.Tensor:
    """[..., 3] -> [..., 1] signed distance."""
    return sdf_apply(params, x, cfg)[..., :1]
