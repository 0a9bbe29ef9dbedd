"""Stage-I appearance shader (split-sum light approximation), every variant.

Counterpart of nero_tpu/fields/app_shading.py. Two paths compute the same
function:

* the whole-shader path (`fused_shader` true, or unset under bf16 hidden
  storage, for a configuration the kernel takes, `fused_shader_active`):
  the heads and their
  encodings run as one function (`ops/shader.py::shader_raw`: the CUDA kernel
  for CUDA tensors, its plain torch version for CPU tensors) and the final
  activations, the human mixing, the FG-LUT lookup and the linear->sRGB
  combine run in `shade_from_raw`, as in `_app_shading_apply_fused`
  (app_shading.py:256-319);
* the per-head path (`fused_shader: false`, or unset under f32 hidden
  storage, or a configuration the kernel does not take,
  app_shading.py:329-371): the
  encodings are tensor ops and every head goes through
  `ops/mlp.py::apply_predictor(fused=cfg.fused_heads)`, which with
  `fused_heads` is the predictor kernel on the card.

Both handle `sphere_direction` and `human_light` (the camera-plane light of
the real captures), which needs the per-ray `human_poses`.

With `n_scenes` (the multi-scene step, parallel/scenes.py) the parameters are
stacked on a leading scene axis and the rows are scene-major: the whole
shader launches once for all scenes (`ops/shader.py::shader_raw_scenes`), the
per-head path runs each scene's heads on its rows.
"""
from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import torch

from nero_tpu_torch.ops.fg_lut import fg_lookup
from nero_tpu_torch.ops.mlp import (apply_predictor, current_hidden_dtype, exp_activation,
                                    init_predictor)
from nero_tpu_torch.ops.shader import (scene_heads, shader_raw, shader_raw_plain,
                                       shader_raw_scenes, unpack_raw)
from nero_tpu_torch.ops.shader import supported as shader_supported
from nero_tpu_torch.utils.color import linear_to_srgb
from nero_tpu_torch.utils.encodings import ide_dim, positional_encode_dim


class AppShadingConfig(NamedTuple):
    human_light: bool = False
    sphere_direction: bool = False
    light_pos_freq: int = 8
    inner_init: float = -0.95
    roughness_init: float = 0.0
    metallic_init: float = 0.0
    light_exp_max: float = 0.0
    feats_dim: int = 256
    ide_deg: int = 5
    # per-head path only: each 4-layer head through the predictor kernel
    fused_heads: bool = False
    # True: the whole-shader kernel, for every variant it takes
    # (ops/shader.py::supported), else the per-head path; None: the same,
    # but the per-head path under f32 hidden storage; False: the per-head
    # path. (The JAX package sends human_light to its per-head path when this
    # is unset, on a timing taken on its TPU; PERF.md has both paths' times
    # on the card.)
    fused_shader: bool | None = None


def fused_shader_active(cfg: AppShadingConfig, storage=None) -> bool:
    """Resolve cfg.fused_shader: False = the per-head path; None under
    `storage` f32 (the render core's resolved `bf16_hidden: false`) = the
    per-head path, since the kernel keeps its operands in bf16 and an
    explicit false is never overridden by it (nero_tpu/fields/
    app_shading.py:212-240); otherwise the whole-shader kernel where it
    takes the configuration (ops/shader.py::supported: nero_tpu's rule, 256
    feats and IDE degree <= 5, and light_pos_freq <= 128, where the light
    PE's top frequency is still a finite f32), else the per-head path
    (`heads_raw`), with a
    warning (once, by the warnings module's default filter) when True was
    asked for, as nero_tpu does (fields/app_shading.py:227-237). A rule about
    the configuration, never about the device."""
    if cfg.fused_shader is False:
        return False
    if cfg.fused_shader is None and storage == torch.float32:
        return False
    if shader_supported(cfg):
        return True
    if cfg.fused_shader:
        warnings.warn("fused_shader=True was requested but the shader kernel does not take "
                      f"this configuration (feats_dim={cfg.feats_dim}, ide_deg={cfg.ide_deg}, "
                      f"light_pos_freq={cfg.light_pos_freq}); taking the per-head path.",
                      RuntimeWarning, stacklevel=2)
    return False


def shading_config_from_dict(cfg: dict) -> AppShadingConfig:
    fields = AppShadingConfig._fields
    return AppShadingConfig(**{k: v for k, v in cfg.items() if k in fields})


def init_app_shading(gen: torch.Generator, cfg: AppShadingConfig = AppShadingConfig(),
                     device="cpu"):
    sph = ide_dim(cfg.ide_deg)
    pos = positional_encode_dim(3, cfg.light_pos_freq)
    ref = positional_encode_dim(3, 6)
    f = cfg.feats_dim
    pred = lambda di, do, fb=None: init_predictor(gen, di, do, final_bias=fb, device=device)
    params = {
        "metallic": pred(f + 3, 1, cfg.metallic_init if cfg.metallic_init != 0 else None),
        "roughness": pred(f + 3, 1, cfg.roughness_init if cfg.roughness_init != 0 else None),
        "albedo": pred(f + 3, 3),
        "outer_light": pred(sph * (2 if cfg.sphere_direction else 1), 3, math.log(0.5)),
        "inner_light": pred(pos + sph, 3, math.log(0.5)),
        "inner_weight": pred(pos + ref, 1, cfg.inner_init),
    }
    if cfg.human_light:
        params["human_light"] = pred(2 * 2 * 6, 4, math.log(0.01))
    return params


def app_shading_apply(params, cfg: AppShadingConfig, fg_lut, points, normals, view_dirs,
                      feature_vectors, human_poses=None, inter_results: bool = False,
                      n_scenes: int | None = None):
    """Shade surface samples; returns (color_srgb, occ_info[, intermediates]).
    human_poses [..., 3, 4] per sample when cfg.human_light. With n_scenes,
    params stacked on a leading scene axis and the rows scene-major."""
    if cfg.human_light and human_poses is None:
        raise ValueError("human_light shading needs human_poses")
    rows = (points, normals, view_dirs, feature_vectors, human_poses)
    if not fused_shader_active(cfg, current_hidden_dtype()):
        packed = heads_raw(params, cfg, *rows, n_scenes=n_scenes)
    elif n_scenes is None:
        packed = shader_raw(params, cfg, *rows)
    else:
        packed = shader_raw_scenes(params, cfg, n_scenes, *rows)
    return shade_from_raw(packed, cfg, fg_lut, inter_results)


def heads_raw(params, cfg: AppShadingConfig, points, normals, view_dirs, feature_vectors,
              human_poses=None, n_scenes: int | None = None) -> torch.Tensor:
    """The per-head path (nero_tpu/fields/app_shading.py:106-186, 329-343):
    the packed raw outputs [..., 24] of `ops/shader.py::shader_raw`, with the
    encodings as tensor ops and every head through `apply_predictor`; with
    n_scenes, each scene's heads on its rows: with `fused_heads` one launch
    of the predictor kernel for all scenes a head and direction, else each
    scene's library products on its rows (torch.mm keeps one scene's bits
    only on one scene's shapes)."""
    head = lambda layers, x: apply_predictor(layers, x, activation="none",
                                             fused=cfg.fused_heads)
    if n_scenes is not None:
        head = scene_heads(n_scenes, head, fused=cfg.fused_heads)
    return shader_raw_plain(params, cfg, points, normals, view_dirs, feature_vectors,
                            human_poses, head=head)


def shade_from_raw(packed: torch.Tensor, cfg: AppShadingConfig, fg_lut,
                   inter_results: bool = False):
    """Final activations + split-sum combine of the packed raw outputs."""
    raw = unpack_raw(packed, cfg.human_light)
    metallic = torch.sigmoid(raw["metallic_z"])
    roughness = torch.sigmoid(raw["roughness_z"])
    albedo = torch.sigmoid(raw["albedo_z"])
    diffuse_light = exp_activation(raw["diffuse_light_z"], cfg.light_exp_max)
    direct_light = exp_activation(raw["direct_light_z"], cfg.light_exp_max)
    indirect_raw = exp_activation(raw["inner_light_z"], cfg.light_exp_max)
    occ_prob = raw["occ_z"] * 0.5 + 0.5
    occ_prob_c = torch.clamp(occ_prob, 0.0, 1.0)

    if cfg.human_light:
        # exp clamped at 0, hit mask on the activated output
        human = exp_activation(raw["human_z"], 0.0) * raw["human_hits"]
        human_light = human[..., :3]
        human_weight = torch.clamp(human[..., 3:], 0.0, 1.0)
        direct_mix = human_light * human_weight + direct_light * (1 - human_weight)
    else:
        direct_mix = direct_light

    specular_light = indirect_raw * occ_prob_c + direct_mix * (1 - occ_prob_c)
    indirect_light = indirect_raw * occ_prob_c
    diffuse_albedo = (1 - metallic) * albedo
    diffuse_color = diffuse_albedo * diffuse_light
    specular_albedo = 0.04 * (1 - metallic) + metallic * albedo
    fg = fg_lookup(fg_lut, torch.clamp(raw["NoV"], 0.0, 1.0), torch.clamp(roughness, 0.0, 1.0))
    specular_ref = specular_albedo * fg[..., 0:1] + fg[..., 1:2]
    specular_color = specular_ref * specular_light
    color = torch.clamp(linear_to_srgb(diffuse_color + specular_color), 0.0, 1.0)

    occ_info = {"reflective": raw["reflective"], "occ_prob": occ_prob}
    if not inter_results:
        return color, occ_info
    srgb = lambda x: torch.clamp(linear_to_srgb(x), 0.0, 1.0)
    inter = {
        "specular_albedo": specular_albedo,
        "specular_ref": torch.clamp(specular_ref, 0.0, 1.0),
        "specular_light": srgb(specular_light),
        "specular_color": srgb(specular_color),
        "diffuse_albedo": diffuse_albedo,
        "diffuse_light": srgb(diffuse_light),
        "diffuse_color": srgb(diffuse_color),
        "metallic": metallic,
        "roughness": roughness,
        "occ_prob": torch.clamp(occ_prob, 0.0, 1.0),
        "indirect_light": indirect_light,
    }
    if cfg.human_light:
        inter["human_light"] = linear_to_srgb(human_light * human_weight)
    return color, occ_info, inter


def predict_materials(params, points, feature_vectors):
    """(metallic, roughness, albedo) in [0, 1] from the shader's material
    heads over [feature, point] (nero_tpu/fields/app_shading.py:181-186),
    plain, as nero_tpu's only caller runs them (models/shape.py:251-253)."""
    inp = torch.cat([feature_vectors, points], dim=-1)
    return tuple(apply_predictor(params[k], inp, activation="sigmoid")
                 for k in ("metallic", "roughness", "albedo"))


def get_camera_plane_intersection(pts: torch.Tensor, dirs: torch.Tensor, poses: torch.Tensor):
    """Intersect rays with the camera XoY plane in 'human' coordinates
    (nero_tpu/fields/app_shading.py:90-103; used by the Stage-II human light).

    pts, dirs [...,3]; poses [...,3,4]. Returns (inter [...,3], dist [...], hits [...]).
    """
    R = poses[..., :, :3]
    t = poses[..., :, 3]
    pts_h = torch.einsum("...ij,...j->...i", R, pts) + t
    dirs_h = torch.einsum("...ij,...j->...i", R, dirs)
    hits = torch.abs(dirs_h[..., 2]) > 1e-4
    dirs_z = torch.where(hits, dirs_h[..., 2], torch.full_like(dirs_h[..., 2], 1e-4))
    dist = -pts_h[..., 2] / dirs_z
    inter = pts_h + dist[..., None] * dirs_h
    return inter, dist, hits
