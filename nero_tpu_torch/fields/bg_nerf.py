"""Background NeRF (NeRF++ outer model), counterpart of
nero_tpu/fields/bg_nerf.py: inputs (x/|x|, 1/|x|) with PE(10), view dirs
with PE(4); 8x256 trunk with the input concatenated after layer 4; alpha,
256-d feature and a 128-wide view branch -> rgb. Plain torch on every device
(the TPU package leaves it to XLA too)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from nero_tpu_torch.ops.mlp import apply_dense, init_dense
from nero_tpu_torch.utils.encodings import positional_encode, positional_encode_dim


class BgNeRFConfig(NamedTuple):
    depth: int = 8
    width: int = 256
    d_in: int = 4
    d_in_view: int = 3
    multires: int = 10
    multires_view: int = 4
    skip: int = 4
    rgb_bias_init: float | None = None


def init_bg_nerf(gen: torch.Generator, cfg: BgNeRFConfig = BgNeRFConfig(), device="cpu"):
    in_pts = positional_encode_dim(cfg.d_in, cfg.multires)
    in_view = positional_encode_dim(cfg.d_in_view, cfg.multires_view)
    w = cfg.width
    dense = lambda di, do: init_dense(gen, di, do, weight_norm=False, device=device)
    pts_layers = [dense(in_pts, w)]
    for i in range(cfg.depth - 1):
        pts_layers.append(dense(w + in_pts if i == cfg.skip else w, w))
    params = {"pts": pts_layers, "views": dense(in_view + w, w // 2),
              "feature": dense(w, w), "alpha": dense(w, 1), "rgb": dense(w // 2, 3)}
    if cfg.rgb_bias_init is not None:
        with torch.no_grad():
            params["rgb"]["b"].fill_(cfg.rgb_bias_init)
    return params


def bg_nerf_apply(params, pts4: torch.Tensor, view_dirs: torch.Tensor,
                  cfg: BgNeRFConfig = BgNeRFConfig()):
    """pts4 [...,4], view_dirs [...,3] -> (alpha [...,1], rgb [...,3]) raw."""
    input_pts = positional_encode(pts4, cfg.multires)
    input_views = positional_encode(view_dirs, cfg.multires_view)
    h = input_pts
    for i, layer in enumerate(params["pts"]):
        h = torch.relu(apply_dense(layer, h))
        if i == cfg.skip:
            h = torch.cat([input_pts, h], dim=-1)
    alpha = apply_dense(params["alpha"], h)
    feature = apply_dense(params["feature"], h)
    hv = torch.relu(apply_dense(params["views"], torch.cat([feature, input_views], dim=-1)))
    return alpha, apply_dense(params["rgb"], hv)
