"""Loss registry (counterpart of nero_tpu/train/losses.py). Every loss is
`fn(data_pr, data_gt, step, cfg, shard=None, scalars=None) -> dict`; the total is the sum
of the means of every key starting with 'loss'. `step` is a Python int.
`scalars` holds the step's numbers that change within a phase
(`loss_numbers`: the eikonal ramp, the init-SDF anneal), which a training
step hands in as 0-d f32 tensors (core/step_graph.py) with the bits of the
Python numbers that stand in for them where it is None.

Under ray data parallelism (`shard`, parallel/mesh.py) the means are over
the global batch: a per-row key (`ROW_KEYS`) by `mean_rows`, and the
regulariser's masked sums and counts by `sum_rows` before the thresholds
and divisions that follow them. Every other key holds one value that is
global already."""
from __future__ import annotations

import math

import torch

from nero_tpu_torch.ops.mlp import scaled
from nero_tpu_torch.parallel.mesh import RayShard, mean_rows, sum_rows

_PASSTHROUGH_RGB_KEYS = ("loss_rgb", "loss_rgb_fine", "loss_global_rgb",
                         "loss_rgb_inner", "loss_rgb0", "loss_rgb1", "loss_masks")
# keys that hold one value per row of the batch
ROW_KEYS = _PASSTHROUGH_RGB_KEYS + ("loss_mat_reg", "loss_diffuse_light")


def nerf_render_loss(data_pr, data_gt, step, cfg, shard=None, scalars=None):
    return {k: data_pr[k] for k in _PASSTHROUGH_RGB_KEYS if k in data_pr}


# the init-SDF regulariser's steps: cosine-annealed to zero over them, then off
INIT_SDF_REG_STEP = 1000


def eikonal_weight(step: int, cfg) -> float:
    """The eikonal term's weight at `step`: ramped up between
    eikonal_weight_anneal_begin and _end where they are set."""
    weight = cfg.get("eikonal_weight", 0.1)
    begin = cfg.get("eikonal_weight_anneal_begin", 0)
    end = cfg.get("eikonal_weight_anneal_end", 0)
    if end > begin:
        return 0.0 if step < begin else weight * min(max((step - begin) / (end - begin), 0.0), 1.0)
    return weight


def init_sdf_reg_anneal(step: int) -> float:
    """The init-SDF regulariser's cosine anneal at `step`, 1 to 0."""
    return (math.cos(min(max(step / INIT_SDF_REG_STEP, 0.0), 1.0) * math.pi) + 1.0) / 2.0


def loss_numbers(step: int, cfg) -> dict:
    """The losses' numbers at `step` that change within a phase."""
    return {"eikonal_weight": eikonal_weight(step, cfg),
            "sdf_reg_anneal": init_sdf_reg_anneal(step)}


def eikonal_loss(data_pr, data_gt, step, cfg, shard=None, scalars=None):
    w = (scalars or loss_numbers(step, cfg))["eikonal_weight"]
    return {"loss_eikonal": scaled(data_pr["gradient_error"], w)}


def std_recorder(data_pr, data_gt, step, cfg, shard=None, scalars=None):
    out = {}
    if "std" in data_pr:
        out["std"] = data_pr["std"]
        if cfg.get("apply_std_loss", False):
            out["loss_std"] = data_pr["std"] * cfg.get("std_loss_weight", 0.05)
    return out


def occ_loss(data_pr, data_gt, step, cfg, shard=None, scalars=None):
    if "loss_occ" in data_pr:
        return {"loss_occ": data_pr["loss_occ"].mean().reshape(1)}
    return {}


def init_sdf_reg_loss(data_pr, data_gt, step, cfg, shard: RayShard | None = None,
                      scalars=None):
    """Sphere prior on the early SDF, cosine-annealed to zero over the first
    INIT_SDF_REG_STEP steps (fixed-shape masked means, over the global batch)."""
    if "sdf_vals" not in data_pr or "sdf_pts_norm" not in data_pr:
        return {}
    norm = torch.as_tensor(data_pr["sdf_pts_norm"])
    sdf = torch.as_tensor(data_pr["sdf_vals"])
    small_mask = (norm < 0.1).to(sdf.dtype)
    small_vec = torch.clamp(sdf - (norm - 0.1), min=0.0) * small_mask
    small_mean = (sum_rows(small_vec.sum(), shard)
                  / torch.clamp(sum_rows(small_mask.sum(), shard), min=1.0))
    small_loss = small_mean / ((small_mean > 1e-5).to(sdf.dtype) + 1e-3)
    large_mask = (norm > 1.05).to(sdf.dtype)
    large_vec = torch.clamp((norm - 1.05) - sdf, min=0.0) * large_mask
    active = sum_rows((large_vec > 1e-5).to(sdf.dtype).sum(), shard)
    large_loss = sum_rows(large_vec.sum(), shard) / (active + 1e-3)
    anneal = (scalars or loss_numbers(step, cfg))["sdf_reg_anneal"]
    gate = float(step < INIT_SDF_REG_STEP)
    return {"loss_sdf_large": (scaled(large_loss, anneal) * gate).reshape(1),
            "loss_sdf_small": (scaled(small_loss, anneal) * gate).reshape(1)}


def mat_reg_loss(data_pr, data_gt, step, cfg, shard=None, scalars=None):
    return {k: data_pr[k] for k in ("loss_mat_reg", "loss_diffuse_light") if k in data_pr}


name2loss = {
    "nerf_render": nerf_render_loss,
    "eikonal": eikonal_loss,
    "std": std_recorder,
    "init_sdf_reg": init_sdf_reg_loss,
    "occ": occ_loss,
    "mat_reg": mat_reg_loss,
}


def compute_losses(loss_names, data_pr, data_gt, step, cfg,
                   shard: RayShard | None = None, scalars: dict | None = None) -> dict:
    log = {}
    for name in loss_names:
        log.update(name2loss[name](data_pr, data_gt, step, cfg, shard, scalars))
    return log


def key_mean(key: str, v: torch.Tensor, shard: RayShard | None = None) -> torch.Tensor:
    """The mean of a log entry over the global batch."""
    return mean_rows(v, shard) if key in ROW_KEYS else v.mean()


def global_means(log: dict, shard: RayShard | None = None) -> dict:
    """Every entry's mean over the global batch, detached: the step's log."""
    with torch.no_grad():
        return {k: key_mean(k, v.detach(), shard) for k, v in log.items()}


def total_loss(log: dict, shard: RayShard | None = None):
    """Sum of the means of every 'loss*' key."""
    return sum(key_mean(k, v, shard) for k, v in log.items() if k.startswith("loss"))
