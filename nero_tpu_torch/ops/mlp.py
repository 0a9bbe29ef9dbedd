"""Weight-norm dense layers and MLP heads as plain dicts of tensors.

Counterpart of nero_tpu/ops/mlp.py. A dense layer is `{v [in,out], g [1,out],
b [out]}` with w = g * v / ||v|| (norm over the fan-in axis), or `{w, b}`
without weight norm. The {v, g, b} leaves are what the optimizer updates;
`resolve_weight_norm` materialises w once per step and autograd chains back
to v and g through it (nero_tpu/ops/mlp.py:124-142).

Initialisers draw from an explicit `torch.Generator` on the CPU and move the
result to the requested device, so a seed gives the same weights on any
device (they differ from nero_tpu's jax.random draws; tests convert weights
with core/convert.py instead).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def torch_default_weight(gen: torch.Generator, d_in: int, d_out: int) -> torch.Tensor:
    bound = 1.0 / math.sqrt(d_in)
    return (torch.rand(d_in, d_out, generator=gen) * 2.0 - 1.0) * bound


def torch_default_bias(gen: torch.Generator, d_in: int, d_out: int) -> torch.Tensor:
    bound = 1.0 / math.sqrt(d_in)
    return (torch.rand(d_out, generator=gen) * 2.0 - 1.0) * bound


def normal_weight(gen: torch.Generator, d_in: int, d_out: int, mean: float = 0.0,
                  std: float = 1.0) -> torch.Tensor:
    return mean + std * torch.randn(d_in, d_out, generator=gen)


def init_dense(gen: torch.Generator, d_in: int, d_out: int, *, weight_norm: bool = True,
               weight: torch.Tensor | None = None, bias=None, device="cpu"):
    w = torch_default_weight(gen, d_in, d_out) if weight is None else weight
    b = torch_default_bias(gen, d_in, d_out) if bias is None else torch.as_tensor(bias)
    b = torch.broadcast_to(b, (d_out,)).float().clone()
    w = w.float()
    if weight_norm:
        g = torch.linalg.norm(w, dim=0, keepdim=True)
        layer = {"v": w, "g": g, "b": b}
    else:
        layer = {"w": w, "b": b}
    return {k: t.to(device).requires_grad_(True) for k, t in layer.items()}


def resolve_dense(layer: dict) -> dict:
    if "v" in layer:
        v = layer["v"]
        norm = torch.linalg.norm(v, dim=0, keepdim=True)
        return {"w": layer["g"] * v / torch.clamp(norm, min=1e-12), "b": layer["b"]}
    return layer


def resolve_weight_norm(params):
    """Materialise weight-norm layers ({v,g,b} -> {w,b}) across a param tree."""
    if isinstance(params, dict):
        if "v" in params and "g" in params:
            return resolve_dense(params)
        return {k: resolve_weight_norm(x) for k, x in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(resolve_weight_norm(x) for x in params)
    return params


def apply_dense(layer: dict, x: torch.Tensor) -> torch.Tensor:
    w = resolve_dense(layer)["w"]
    return x @ w + layer["b"]


def softplus_beta(x: torch.Tensor, beta: float = 100.0) -> torch.Tensor:
    """softplus(beta x) / beta (linear above beta x = 20, where the two
    differ by < 3e-11 after the 1/beta scale)."""
    return F.softplus(x, beta=beta)


def exp_activation(x: torch.Tensor, max_light: float = 5.0) -> torch.Tensor:
    """exp with an upper clamp on the pre-activation (light heads)."""
    return torch.exp(torch.clamp(x, max=max_light))


def init_predictor(gen: torch.Generator, d_in: int, d_out: int, *, weight_norm: bool = True,
                   run_dim: int = 256, final_bias: float | None = None, device="cpu"):
    """Linear(d_in,256) ReLU Linear ReLU Linear ReLU Linear(256,d_out)."""
    dims = [(d_in, run_dim), (run_dim, run_dim), (run_dim, run_dim), (run_dim, d_out)]
    layers = [init_dense(gen, di, do, weight_norm=weight_norm, device=device)
              for di, do in dims]
    if final_bias is not None:
        with torch.no_grad():
            layers[-1]["b"].fill_(final_bias)
    return layers


def predictor_raw(layers, x: torch.Tensor) -> torch.Tensor:
    """The 4-layer head without its final activation."""
    h = x
    for layer in layers[:-1]:
        h = torch.relu(apply_dense(layer, h))
    return apply_dense(layers[-1], h)


def apply_predictor(layers, x: torch.Tensor, activation: str = "sigmoid",
                    exp_max: float = 0.0, fused: bool = False) -> torch.Tensor:
    """The 4-layer head with its final activation: 'sigmoid', 'exp' (clamped
    at exp_max) or 'none'. `fused` sends the linear/ReLU body through the
    predictor kernel (ops/predictor.py: on a CUDA tensor the kernel, on a CPU
    tensor its plain version); the activation stays here either way."""
    if fused:
        from nero_tpu_torch.ops.predictor import predictor
        h = predictor(layers, x)
    else:
        h = predictor_raw(layers, x)
    if activation == "exp":
        return exp_activation(h, exp_max)
    if activation == "sigmoid":
        return torch.sigmoid(h)
    if activation == "none":
        return h
    raise NotImplementedError(activation)
