"""NeuS single-variance network: one learnable scalar -> inv_s
(counterpart of nero_tpu/fields/variance.py)."""
from __future__ import annotations

import torch


def init_variance(init_val: float = 0.3, device="cpu"):
    return {"variance": torch.tensor(init_val, dtype=torch.float32, device=device,
                                     requires_grad=True)}


def inv_s(params, activation: str = "exp") -> torch.Tensor:
    v = params["variance"]
    if activation == "exp":
        return torch.exp(v * 10.0)
    if activation == "linear":
        return v * 10.0
    if activation == "square":
        return (v * 10.0) ** 2
    raise NotImplementedError(activation)
