"""Linear -> sRGB transfer function and uint8 image mapping
(counterpart of nero_tpu/utils/color.py)."""
from __future__ import annotations

import numpy as np
import torch

_F32_EPS = float(np.finfo(np.float32).eps)


def linear_to_srgb(linear: torch.Tensor) -> torch.Tensor:
    srgb0 = 323.0 / 25.0 * linear
    srgb1 = (211.0 * torch.clamp(linear, min=_F32_EPS) ** (5.0 / 12.0) - 11.0) / 200.0
    return torch.where(linear <= 0.0031308, srgb0, srgb1)


def color_map_backward(img_float) -> np.ndarray:
    """float [0,1] image -> uint8 with rounding and clipping."""
    img = np.asarray(img_float)
    return np.clip(img * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)
