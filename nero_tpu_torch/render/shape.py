"""Stage-I shape renderer: NeuS SDF volume rendering with split-sum shading.

Counterpart of nero_tpu/render/shape.py: hierarchical sampling (64 uniform +
up-sample rounds), NeuS alpha with cosine annealing, the NeRF++ background
on the outer samples, the appearance shader on the inner lattice, alpha
compositing, the eikonal / occlusion / init-sdf regulariser inputs.

The hot functions go through the port's CUDA kernels on the card:
`ops/sdf_grad.py::sdf_with_grad` in `compute_sdf_alpha`, the shader inside
`app_shading_apply` (`ops/shader.py::shader_raw`, or head by head through
`ops/predictor.py`), and, with `use_fused_sdf`, `ops/sdf_fwd.py` for the
no-gradient SDF values of the sampler and the occlusion marches
(`make_nograd_sdf_fn`). The switches `bg_on_inner`, `shade_top_k` and
`remat_shader` are plain torch here as they are plain JAX there.

The precision switches resolve by nero_tpu's rules (render/shape.py:127-149)
with CUDA in the TPU's place, in one place (`ShapeConfig.hidden_act_dtype`,
`ShapeConfig.grad_mode`, `ShapeConfig.resolved`):

* `bf16_hidden`: the storage of hidden activations in the sampler and the
  render core (ops/mlp.py::hidden_dtype); unset = bf16 on CUDA, f32 on the
  CPU;
* `sdf_grad_mode`: `fused` (the SDF-with-gradient kernel), `rev` or `fwd`
  (ops/sdf_grad.py); unset = `fused` on CUDA where the kernel takes the SDF
  and the storage is bf16, else `rev`; `fused` asked for where the kernel
  cannot run (a CPU model, another SDF topology) warns and takes `rev`.

A value outside these raises ValueError. `use_fused_sdf` is dropped for an
SDF that the value-only kernel does not take (`shape_config_from_dict`).

Under ray data parallelism (`shard`, parallel/mesh.py) each rank renders its
rows of the global batch: the random draws are of the global batch's shape
(`draw_rows`), the occlusion loss sizes its per-ray candidates from the
global ray count, and the masked means of the eikonal and occlusion terms
sum their numerators and counts over the ranks (`sum_rows`).

With parameters stacked on a leading scene axis (parallel/scenes.py, the
multi-scene step of models/multi_scene.py) `render` renders S scenes' rays
in one pass, as nero_tpu's `jax.vmap` of one scene's step does: the rays
are scene-major, the SDF-with-gradient and the whole shader launch once for
all scenes (`sdf_with_grad_scenes`, `shader_raw_scenes`), the library
products (background NeRF, the no-gradient SDF values) and the per-head
shader run scene by scene, the draws come from each scene's generator, the
occlusion loss sizes its candidates from one scene's ray count, and every
reduction over rows is per scene; the scalar outputs are then [S].
"""
from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import torch
import torch.utils.checkpoint

from nero_tpu_torch.core.trace import span, traced
from nero_tpu_torch.fields.app_shading import (AppShadingConfig, app_shading_apply,
                                               init_app_shading, shading_config_from_dict)
from nero_tpu_torch.fields.bg_nerf import BgNeRFConfig, bg_nerf_apply, init_bg_nerf
from nero_tpu_torch.fields.intersection import get_intersection
from nero_tpu_torch.fields.sdf import SDFConfig, init_sdf, sdf_value
from nero_tpu_torch.fields.variance import init_variance, inv_s as variance_inv_s
from nero_tpu_torch.ops.mlp import (current_precision, hidden_dtype, precision_of,
                                    resolve_weight_norm, storage_dtype)
from nero_tpu_torch.ops.sample_pdf import sample_pdf
from nero_tpu_torch.ops.sdf_fwd import make_sdf_fwd_fn, make_sdf_fwd_scenes_fn
from nero_tpu_torch.ops.sdf_fwd import supported as sdf_fwd_supported
from nero_tpu_torch.ops.sdf_grad import GRAD_MODES, sdf_with_grad, sdf_with_grad_scenes
from nero_tpu_torch.ops.sdf_grad import supported as sdf_kernel_supported
from nero_tpu_torch.parallel.mesh import RayShard, draw_rows, sum_rows
from nero_tpu_torch.parallel.scenes import (n_scenes, per_row, row_values, scene_map,
                                            scene_rand, scene_slice, scene_sum)
from nero_tpu_torch.utils.color import linear_to_srgb


class ShapeConfig(NamedTuple):
    n_samples: int = 64
    n_bg_samples: int = 32
    n_importance: int = 64
    up_sample_steps: int = 4
    perturb: float = 1.0
    anneal_end: int = 50000
    train_ray_num: int = 512
    test_ray_num: int = 1024
    clip_sample_variance: bool = True
    std_act: str = "exp"
    inv_s_init: float = 0.3
    freeze_inv_s_step: int | None = None
    sdf_n_layers: int = 8
    sdf_freq: int = 6
    sdf_d_out: int = 257
    sdf_bias: float = 0.5
    geometry_init: bool = True
    rgb_loss: str = "charbonier"
    apply_occ_loss: bool = True
    occ_loss_step: int = 20000
    occ_loss_max_pn: int = 2048
    occ_sdf_thresh: float = 0.01
    shader: AppShadingConfig = AppShadingConfig()
    fixed_camera: bool = False
    # the background NeRF on the inner lattice too (inner samples outside
    # the unit sphere then take its alpha and colour); off: outer samples only
    bg_on_inner: bool = False
    # recompute the shader in the backward pass instead of keeping its
    # activations (torch.utils.checkpoint); None = off
    remat_shader: bool | None = None
    # the no-gradient SDF values (sampler, occlusion marches) through the
    # value-only kernel of ops/sdf_fwd.py
    use_fused_sdf: bool = False
    # from occ_loss_step on, shade only the k inner samples of each ray that
    # carry the most composited weight (0 = all); training only
    shade_top_k: int = 0
    # the spatial SDF gradient: 'fused', 'rev' or 'fwd'; None = `grad_mode`'s rule
    sdf_grad_mode: str | None = None
    # hidden activations of the SDF and the shader's heads stored in bf16;
    # None = on for a CUDA model
    bf16_hidden: bool | None = None

    def hidden_act_dtype(self, device) -> torch.dtype:
        """The hidden storage dtype on `device` (ops/mlp.py::storage_dtype)."""
        return storage_dtype(self.bf16_hidden, device)

    def grad_mode(self, device) -> str:
        """The resolved sdf_grad_mode on `device`. The kernel runs where the
        device is CUDA and it takes the SDF (ops/sdf_grad.py::supported:
        nero_tpu's rule, multires 1-20 included); unset picks it only where the
        storage is bf16 too, since the kernel stores its activations in bf16
        and an explicit bf16_hidden=false is not overridden (nero_tpu/render/
        shape.py:134-149)."""
        mode = _checked_grad_mode(self)
        kernel_ok = torch.device(device).type == "cuda" and sdf_kernel_supported(self.sdf_cfg)
        if mode is None:
            return ("fused" if kernel_ok and self.hidden_act_dtype(device) == torch.bfloat16
                    else "rev")
        if mode == "fused" and not kernel_ok:
            warnings.warn(f"sdf_grad_mode='fused' was requested but the SDF-with-gradient kernel "
                          f"does not run here (device {torch.device(device).type}, "
                          f"{_topology(self)}); taking 'rev'.", RuntimeWarning, stacklevel=2)
            return "rev"
        return mode

    def resolved(self, device) -> "ShapeConfig":
        """This config with both precision switches set to what they resolve
        to on `device`."""
        return self._replace(bf16_hidden=self.hidden_act_dtype(device) == torch.bfloat16,
                             sdf_grad_mode=self.grad_mode(device))

    @property
    def n_inner(self) -> int:
        return self.n_samples + self.n_importance

    @property
    def n_total(self) -> int:
        return self.n_inner + self.n_bg_samples

    @property
    def sdf_cfg(self) -> SDFConfig:
        return SDFConfig(d_out=self.sdf_d_out, n_layers=self.sdf_n_layers,
                         skip=self.sdf_n_layers // 2, multires=self.sdf_freq,
                         bias=self.sdf_bias, geometric_init=self.geometry_init)


def shape_config_from_dict(cfg: dict) -> ShapeConfig:
    """The ShapeConfig of a config dict; an unknown value of `sdf_grad_mode`
    or `bf16_hidden` raises ValueError. `use_fused_sdf` with an SDF that the
    value-only kernel does not take (`ops/sdf_fwd.py::supported`: nero_tpu's
    rule, 8 x 256 layers with the skip at 4, weight norm, multires 1-20) is
    dropped with a warning, as nero_tpu drops it (render/shape.py:179-180): a
    rule about the configuration, never about the device."""
    fields = {k: v for k, v in cfg.items() if k in ShapeConfig._fields}
    fields["shader"] = shading_config_from_dict(cfg.get("shader_config", {}))
    scfg = ShapeConfig(**fields)
    # an unknown value of a precision switch raises here
    _checked_grad_mode(scfg)
    storage_dtype(scfg.bf16_hidden, "cpu")
    if scfg.use_fused_sdf and not sdf_fwd_supported(scfg.sdf_cfg):
        warnings.warn("use_fused_sdf=True was requested but the value-only SDF kernel does not "
                      f"take this SDF ({_topology(scfg)}); taking sdf_value.",
                      RuntimeWarning, stacklevel=2)
        scfg = scfg._replace(use_fused_sdf=False)
    return scfg


def _checked_grad_mode(scfg: ShapeConfig):
    mode = scfg.sdf_grad_mode
    if mode is not None and mode not in GRAD_MODES:
        raise ValueError(f"sdf_grad_mode must be one of {GRAD_MODES} or unset, got {mode!r}")
    return mode


def _topology(scfg: ShapeConfig) -> str:
    return (f"sdf_n_layers={scfg.sdf_n_layers}, sdf_freq={scfg.sdf_freq}, "
            f"sdf_d_out={scfg.sdf_d_out}")


def make_nograd_sdf_fn(params, scfg: ShapeConfig):
    """SDF value function of the no-gradient paths: the value-only kernel
    when `use_fused_sdf` (its plain version on CPU tensors), else `sdf_value`.
    With S scenes (equal parts of the rows, scene-major) and `use_fused_sdf`,
    one launch of the kernel for all scenes; `sdf_value`, whose library
    products keep one scene's bits only on one scene's shapes, each scene's
    function on its part of the rows."""
    S = n_scenes(params)
    if S is None:
        return _nograd_sdf_fn(params["sdf"], scfg)
    if scfg.use_fused_sdf:
        return make_sdf_fwd_scenes_fn(params["sdf"], S, scfg.sdf_cfg)
    fns = [_nograd_sdf_fn(scene_slice(params["sdf"], s), scfg) for s in range(S)]
    return lambda x: torch.cat([f(c) for f, c in zip(fns, x.chunk(S, 0))])


def _nograd_sdf_fn(sdf_params, scfg: ShapeConfig):
    if scfg.use_fused_sdf:
        return make_sdf_fwd_fn(sdf_params, scfg.sdf_cfg)
    return lambda x: sdf_value(sdf_params, x, scfg.sdf_cfg)


def init_shape_params(gen: torch.Generator, scfg: ShapeConfig, device="cpu"):
    return {
        "sdf": init_sdf(gen, scfg.sdf_cfg, device=device),
        "variance": init_variance(scfg.inv_s_init, device=device),
        "bg": init_bg_nerf(gen, BgNeRFConfig(rgb_bias_init=math.log(0.5)), device=device),
        "shader": init_app_shading(gen, scfg.shader, device=device),
    }


# ---------------------------------------------------------------------------
# hierarchical sampling (no gradient)
# ---------------------------------------------------------------------------


def _upsample_z(rays_o, rays_d, z_vals, sdf, n_new, inv_s):
    """One NeuS up-sample round, deterministic."""
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    radius = torch.linalg.norm(pts, dim=-1)
    inside = (radius[:, :-1] < 1.0) | (radius[:, 1:] < 1.0)
    prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
    prev_z, next_z = z_vals[:, :-1], z_vals[:, 1:]
    mid_sdf = (prev_sdf + next_sdf) * 0.5
    cos_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)
    prev_cos = torch.cat([torch.zeros_like(cos_val[:, :1]), cos_val[:, :-1]], dim=-1)
    cos_val = torch.minimum(prev_cos, cos_val)
    cos_val = torch.clamp(cos_val, -1e3, 0.0) * inside.to(sdf.dtype)
    dist = next_z - prev_z
    prev_cdf = torch.sigmoid((mid_sdf - cos_val * dist * 0.5) * inv_s)
    next_cdf = torch.sigmoid((mid_sdf + cos_val * dist * 0.5) * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-7],
                                    dim=-1), dim=-1)[:, :-1]
    return sample_pdf(z_vals, alpha * trans, n_new)


@torch.no_grad()
def sample_z_vals(params, scfg: ShapeConfig, rays_o, rays_d, near, far,
                  gen: torch.Generator | None = None, perturb: float = 1.0,
                  shard: RayShard | None = None):
    """Inner z values [R, n_inner] and background z values [R, n_bg]; the
    SDF values in the storage dtype (nero_tpu/render/shape.py:278)."""
    with span("nero.render.sampler"), hidden_dtype(scfg.hidden_act_dtype(rays_o.device)):
        return _sample_z_vals(params, scfg, rays_o, rays_d, near, far, gen, perturb, shard)


def _sample_z_vals(params, scfg: ShapeConfig, rays_o, rays_d, near, far, gen, perturb, shard):
    r = rays_o.shape[0]
    sn = scfg.n_samples
    dev, dt = rays_o.device, rays_o.dtype
    z = torch.linspace(0.0, 1.0, sn, dtype=dt, device=dev)
    z_vals = near + (far - near) * z[None, :]
    z_out_lin = torch.linspace(1e-3, 1.0 - 1.0 / (scfg.n_bg_samples + 1.0),
                               scfg.n_bg_samples, dtype=dt, device=dev)
    if perturb > 0 and gen is not None:
        rand = scene_rand(gen, dev, dt)
        t_rand = draw_rows(rand, (r, 1), shard) - 0.5
        z_vals = z_vals + t_rand * 2.0 / sn
        mids = 0.5 * (z_out_lin[1:] + z_out_lin[:-1])
        upper = torch.cat([mids, z_out_lin[-1:]])
        lower = torch.cat([z_out_lin[:1], mids])
        t2 = draw_rows(rand, (r, scfg.n_bg_samples), shard)
        z_out = lower[None, :] + (upper - lower)[None, :] * t2
    else:
        z_out = z_out_lin[None, :].expand(r, scfg.n_bg_samples)
    z_vals_outside = far / torch.flip(z_out, dims=[-1]) + 1.0 / scfg.n_bg_samples

    n_new = scfg.n_importance // scfg.up_sample_steps
    base_inv_s = variance_inv_s(params["variance"], scfg.std_act)
    sdf_fn = make_nograd_sdf_fn(params, scfg)
    sdf = sdf_fn(rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None])[..., 0]
    for i in range(scfg.up_sample_steps):
        if scfg.clip_sample_variance:
            inv_s_i = torch.clamp(base_inv_s, max=64.0 * 2 ** i)
        else:
            inv_s_i = torch.tensor(64.0 * 2 ** i, dtype=dt, device=dev)
        new_z = _upsample_z(rays_o, rays_d, z_vals, sdf, n_new, row_values(inv_s_i, z_vals))
        z_cat = torch.cat([z_vals, new_z], dim=-1)
        if i + 1 < scfg.up_sample_steps:
            new_sdf = sdf_fn(rays_o[:, None, :] + rays_d[:, None, :] * new_z[..., None])[..., 0]
            # sort z and carry sdf along (the two-key lax.sort of nero_tpu)
            z_vals, order = torch.sort(z_cat, dim=-1, stable=True)
            sdf = torch.gather(torch.cat([sdf, new_sdf], dim=-1), -1, order)
        else:
            z_vals = torch.sort(z_cat, dim=-1, stable=True).values
    return z_vals, z_vals_outside


# ---------------------------------------------------------------------------
# core rendering
# ---------------------------------------------------------------------------


@traced("nero.render.sdf")
def compute_sdf_alpha(params, scfg: ShapeConfig, points, dists, dirs, cos_anneal_ratio,
                      step: int):
    """NeuS alpha on the inner lattice. points [R,S,3] -> alpha, grads, feats, inv_s, sdf
    (with scenes, inv_s [S])."""
    S = n_scenes(params)
    if S is None:
        sdf, feats, grads = sdf_with_grad(params["sdf"], points, scfg.sdf_cfg,
                                          scfg.sdf_grad_mode)
    else:
        sdf, feats, grads = (t.flatten(0, 1) for t in sdf_with_grad_scenes(
            params["sdf"], points.reshape((S, -1) + points.shape[1:]), scfg.sdf_cfg,
            scfg.sdf_grad_mode))
    sdf = sdf[..., 0]
    inv_s = torch.clamp(variance_inv_s(params["variance"], scfg.std_act), 1e-6, 1e6)
    if scfg.freeze_inv_s_step is not None and step < scfg.freeze_inv_s_step:
        inv_s = inv_s.detach()
    true_cos = torch.sum(dirs * grads, dim=-1)
    iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                 + torch.relu(-true_cos) * cos_anneal_ratio)
    est_next = sdf + iter_cos * dists * 0.5
    est_prev = sdf - iter_cos * dists * 0.5
    prev_cdf = torch.sigmoid(est_prev * per_row(inv_s, est_prev))
    next_cdf = torch.sigmoid(est_next * per_row(inv_s, est_next))
    alpha = torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)
    return alpha, grads, feats, inv_s, sdf


@traced("nero.render.background")
def compute_density_alpha(params, points, dists, dirs):
    """Background NeRF++ alpha/color on arbitrary points."""
    norm = torch.clamp(torch.linalg.norm(points, dim=-1, keepdim=True), min=1e-3)
    pts4 = torch.cat([points / norm, 1.0 / norm], dim=-1)
    S = n_scenes(params)
    if S is None:
        density, color = bg_nerf_apply(params["bg"], pts4, dirs)
    else:
        density, color = scene_map(bg_nerf_apply, S, params["bg"], pts4, dirs)
    alpha = 1.0 - torch.exp(-torch.nn.functional.softplus(density[..., 0]) * dists)
    color = linear_to_srgb(torch.exp(torch.clamp(color, max=5.0)))
    return alpha, color


def _composite(alpha):
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-7],
                                    dim=-1), dim=-1)[..., :-1]
    return alpha * trans


@traced("nero.render.occ")
def compute_occ_loss(params, scfg: ShapeConfig, gen, points, reflective, occ_prob, sdf,
                     grads, dirs, shard: RayShard | None = None):
    """Occlusion-probability supervision: per ray the top k' = max_pn // R of
    the masked candidates by random score (nero_tpu/render/shape.py:379-415);
    R is the global batch's ray count, of one scene. With scenes, [S]."""
    r, s = points.shape[:2]
    S = n_scenes(params)
    with torch.no_grad():
        mask = ((torch.linalg.norm(points, dim=-1) < 0.999)
                & (torch.abs(sdf) < scfg.occ_sdf_thresh)
                & (torch.sum(grads * dirs, dim=-1) < 0.0))
        rand = draw_rows(scene_rand(gen, points.device, points.dtype), (r, s), shard)
        score = torch.where(mask, rand, torch.full_like(rand, -1.0))
        rays = shard.n if shard is not None else r if S is None else r // S
        kpr = max(1, min(scfg.occ_loss_max_pn // rays, s))
        top_vals, top_idx = torch.topk(score, kpr, dim=-1)
        valid = (top_vals > 0.0).reshape(-1).to(points.dtype)
        idx3 = top_idx[..., None].expand(r, kpr, 3)
        pts_k = torch.gather(points, 1, idx3).reshape(r * kpr, 3)
        refl_k = torch.gather(reflective.detach(), 1, idx3).reshape(r * kpr, 3)
        inv_s = row_values(variance_inv_s(params["variance"], scfg.std_act), pts_k)
        sdf_fun = make_nograd_sdf_fn(params, scfg)
        _, inter_prob, _ = get_intersection(sdf_fun, inv_s, pts_k, refl_k, sn0=64, sn1=16)
        occ_gt = torch.sum(inter_prob, dim=-1)
    occ_k = torch.gather(occ_prob, 1, top_idx).reshape(r * kpr)
    l1 = torch.abs(occ_k - occ_gt)
    return (sum_rows(scene_sum(l1 * valid, S), shard)
            / torch.clamp(sum_rows(scene_sum(valid, S), shard), min=1.0))


def top_k_lowest_index_first(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis, ties
    broken towards the lower index as jax.lax.top_k does: a stable descending
    sort keeps equal entries (the zero weights behind a surface) in their
    original order. torch.topk promises no order among ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def render_core(params, scfg: ShapeConfig, fg_lut, rays_o, rays_d, z_full, cos_anneal_ratio,
                step: int, is_train: bool, gen: torch.Generator | None = None,
                human_poses: torch.Tensor | None = None,
                shard: RayShard | None = None) -> dict:
    """z_full [R, n_total] (inner z then background z). `params` resolved.
    human_poses [R, 3, 4] per ray when the shader has the human light.
    The precision switches resolve here, on the rays' device (a model's
    config is resolved already); hidden activations in the storage dtype
    (nero_tpu/render/shape.py:421)."""
    scfg = scfg.resolved(rays_o.device)
    with hidden_dtype(scfg.hidden_act_dtype(rays_o.device)):
        return _render_core(params, scfg, fg_lut, rays_o, rays_d, z_full, cos_anneal_ratio,
                            step, is_train, gen, human_poses, shard)


def _render_core(params, scfg: ShapeConfig, fg_lut, rays_o, rays_d, z_full, cos_anneal_ratio,
                 step: int, is_train: bool, gen, human_poses, shard) -> dict:
    r, s_total = z_full.shape
    s_inner = scfg.n_inner
    S = n_scenes(params)
    dists = z_full[..., 1:] - z_full[..., :-1]
    dists = torch.cat([dists, dists[..., -1:]], dim=-1)
    mid_z = z_full + dists * 0.5
    points = rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., None]
    inner_mask = torch.linalg.norm(points, dim=-1) <= 1.0
    dirs = rays_d[:, None, :].expand(points.shape)
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12)

    if scfg.bg_on_inner:
        # background on the full lattice, selected by the inner mask below
        alpha_bg, color_bg = compute_density_alpha(params, points, dists, -dirs)
    else:
        # background only on the outer samples
        alpha_out, color_out = compute_density_alpha(
            params, points[:, s_inner:], dists[:, s_inner:], -dirs[:, s_inner:])
        alpha_bg = torch.cat([alpha_out.new_zeros((r, s_inner)), alpha_out], dim=1)
        color_bg = torch.cat([color_out.new_zeros((r, s_inner, 3)), color_out], dim=1)

    pts_in = points[:, :s_inner]
    dists_in = dists[:, :s_inner]
    dirs_in = dirs[:, :s_inner]
    alpha_sdf, grads, feats, inv_s, sdf = compute_sdf_alpha(
        params, scfg, pts_in, dists_in, dirs_in, cos_anneal_ratio, step)
    hp_in = None if human_poses is None else human_poses[:, None].expand(r, s_inner, 3, 4)
    inner_in = inner_mask[:, :s_inner]
    alpha = torch.cat([torch.where(inner_in, alpha_sdf, alpha_bg[:, :s_inner]),
                       alpha_bg[:, s_inner:]], dim=1)
    # the weights depend on alpha only: they exist before any shading, so the
    # shader can be kept to the samples that carry mass
    weights = _composite(alpha)
    mask_sdf = torch.cat([inner_in, inner_in.new_zeros((r, s_total - s_inner))], dim=1)
    rgb_bg_part = torch.sum(color_bg * (weights * ~mask_sdf)[..., None], dim=1)

    state = current_precision()

    def fn(*a):
        # the storage and product contexts again: the recompute of
        # remat_shader runs in the backward pass, on CUDA on autograd's
        # device thread, where neither context is seen
        with span("nero.render.shader"), precision_of(state):
            return app_shading_apply(params["shader"], scfg.shader, fg_lut, *a, n_scenes=S)

    def shade(pts, nrm, view, ft, hp):
        args = [pts, nrm, view, ft] + ([] if hp is None else [hp])
        if is_train and scfg.remat_shader and torch.is_grad_enabled():
            # keep no shader activation for the backward: run it again there
            return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                     preserve_rng_state=False)
        return fn(*args)

    want_occ = scfg.apply_occ_loss and is_train
    occ_phase = step >= scfg.occ_loss_step
    k = scfg.shade_top_k
    if is_train and k and k < s_inner and occ_phase:
        # only the k samples of each ray with the most weight are shaded
        wk, idx = top_k_lowest_index_first(weights[:, :s_inner] * inner_in, k)
        sel = lambda a: torch.gather(a, 1, idx.reshape(r, k, *([1] * (a.dim() - 2)))
                                     .expand(r, k, *a.shape[2:]))
        pts_s, grads_s, dirs_s, sdf_s = sel(pts_in), sel(grads), sel(dirs_in), sel(sdf)
        color_s, occ_info = shade(pts_s, grads_s, -dirs_s, sel(feats),
                                  None if hp_in is None else sel(hp_in))
        ray_rgb = rgb_bg_part + torch.sum(color_s * wk[..., None], dim=1)
    else:
        pts_s, grads_s, dirs_s, sdf_s = pts_in, grads, dirs_in, sdf
        color_s, occ_info = shade(pts_in, grads, -dirs_in, feats, hp_in)
        w_sdf = weights[:, :s_inner] * inner_in
        ray_rgb = rgb_bg_part + torch.sum(color_s * w_sdf[..., None], dim=1)

    grad_err = (torch.linalg.norm(grads, dim=-1) - 1.0) ** 2
    n_inside = torch.clamp(sum_rows(scene_sum(inner_in, S), shard), min=1.0)
    outputs = {
        "ray_rgb": ray_rgb,
        "gradient_error": (sum_rows(scene_sum(grad_err * inner_in, S), shard)
                           / n_inside).reshape(-1),
        # a scene's mean of its one value is that value
        "std": torch.mean(1.0 / inv_s).reshape(1) if S is None else 1.0 / inv_s,
        "sdf_pts_norm": torch.linalg.norm(pts_in, dim=-1).reshape(-1),
        "sdf_vals": sdf.reshape(-1),
    }
    if want_occ:
        if occ_phase:
            loss_occ = compute_occ_loss(params, scfg, gen, pts_s, occ_info["reflective"],
                                        occ_info["occ_prob"][..., 0], sdf_s, grads_s, dirs_s,
                                        shard)
        else:
            loss_occ = ray_rgb.new_zeros(() if S is None else (S,))
        outputs["loss_occ"] = loss_occ.reshape(-1)
    if not is_train:
        outputs.update(compute_validation_info(params, scfg, fg_lut, z_full, rays_o, rays_d,
                                               weights, human_poses))
    return outputs


def compute_validation_info(params, scfg: ShapeConfig, fg_lut, z_vals, rays_o, rays_d,
                            weights, human_poses=None) -> dict:
    """Depth/normal/material maps + traced occ-prob ground truth."""
    depth = torch.sum(weights * z_vals, dim=-1, keepdim=True)
    points = depth * rays_d + rays_o
    _, feats, grads = sdf_with_grad(params["sdf"], points, scfg.sdf_cfg, scfg.sdf_grad_mode)
    inner = (torch.linalg.norm(points, dim=-1, keepdim=True) <= 1.0).to(points.dtype)
    normal = (grads / torch.clamp(torch.linalg.norm(grads, dim=-1, keepdim=True), min=1e-12)
              + 1.0) * 0.5 * inner
    view = -rays_d / torch.clamp(torch.linalg.norm(rays_d, dim=-1, keepdim=True), min=1e-12)
    _, occ_info, inter = app_shading_apply(params["shader"], scfg.shader, fg_lut, points,
                                           grads, view, feats, human_poses,
                                           inter_results=True)
    inv_s = variance_inv_s(params["variance"], scfg.std_act)
    sdf_fun = make_nograd_sdf_fn(params, scfg)
    _, occ_prob, _ = get_intersection(sdf_fun, inv_s, points, occ_info["reflective"],
                                      sn0=128, sn1=9)
    outputs = {"depth": depth, "normal": normal,
               "occ_prob_gt": torch.sum(occ_prob, dim=-1, keepdim=True)}
    for k, v in inter.items():
        outputs[k] = v * inner
    return outputs


def render(params, scfg: ShapeConfig, fg_lut, rays_o, rays_d, near, far, step: int,
           gen: torch.Generator | None = None, is_train: bool = True,
           perturb_overwrite: float = -1.0, cos_anneal_ratio=None,
           human_poses: torch.Tensor | None = None, shard: RayShard | None = None) -> dict:
    """Full Stage-I render of a ray batch. Weight norm is resolved once here
    and autograd chains back to {v, g} through it. human_poses [R, 3, 4]
    per ray when the shader has the human light. With `shard` the rays are
    this rank's rows of the global batch."""
    params = resolve_weight_norm(params)
    perturb = scfg.perturb if perturb_overwrite < 0 else perturb_overwrite
    if cos_anneal_ratio is None:
        cos_anneal_ratio = 1.0 if scfg.anneal_end < 0 else min(1.0, step / scfg.anneal_end)
    z_inner, z_out = sample_z_vals(params, scfg, rays_o, rays_d, near, far,
                                   gen=gen if perturb > 0 else None, perturb=perturb, shard=shard)
    z_full = torch.cat([z_inner, z_out], dim=-1)
    return render_core(params, scfg, fg_lut, rays_o, rays_d, z_full, cos_anneal_ratio, step,
                       is_train, gen=gen, human_poses=human_poses, shard=shard)


def compute_rgb_loss(rgb_pr, rgb_gt, kind: str = "charbonier"):
    if kind == "l2":
        return torch.sum((rgb_pr - rgb_gt) ** 2, dim=-1)
    if kind == "l1":
        return torch.sum(torch.abs(rgb_pr - rgb_gt), dim=-1)
    if kind == "smooth_l1":
        beta = 0.25
        d = torch.abs(rgb_pr - rgb_gt)
        return torch.sum(torch.where(d < beta, 0.5 * d ** 2 / beta, d - 0.5 * beta), dim=-1)
    if kind == "charbonier":
        return torch.sqrt(torch.sum((rgb_gt - rgb_pr) ** 2, dim=-1) + 0.001)
    raise NotImplementedError(kind)
