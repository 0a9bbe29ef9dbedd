"""Stage-II Monte-Carlo BRDF shader (Cook-Torrance GGX with traced visibility).

Counterpart of nero_tpu/fields/mc_shading.py: per-point material features -> metallic / roughness / albedo heads;
cosine-sampled diffuse + GGX-importance-sampled specular directions from a
Fibonacci-sphere stratification with a random azimuth rotation in training;
every sample direction is traced against the fixed mesh -- hits query the
indirect-light MLP, misses the environment MLP (+ the optional camera-plane
"human" light); an MIS-style mixed estimator combines them; plus the
material-smoothness and min/max regularisers.

The [points, sample dirs] block is shaded fully vectorised. Where the JAX
functions take a PRNG key, these take a `torch.Generator` (`gen`), or the
uniform / normal draws themselves (`rot`, `draws`) so that a test can feed
both packages the same numbers. The tracer's outputs are detached. The hit /
miss compaction keeps the JAX package's static-capacity semantics: no
boolean-mask indexing, so no host synchronisation in the step.

Under ray data parallelism (`shard`, parallel/mesh.py) the points are this
rank's rows of the global batch: the rotation and regulariser draws are of
the global batch's shape (`draw_rows`), the regulariser's min/max clamp sums
over the global batch, and a compaction keeps nero_tpu's global function: K
from the global entry count, and the first K selected entries of the global
batch in row order, which is this rank's entries whose global index (the
counts of the ranks before it plus its own) is under K.
"""
from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import numpy as np
import torch

from nero_tpu_torch.fields.app_shading import get_camera_plane_intersection
from nero_tpu_torch.ops.lights import inner_light_input, lights_raw, outer_light_input
from nero_tpu_torch.ops.lights import supported as lights_kernel_supported
from nero_tpu_torch.ops.mlp import (apply_dense, apply_predictor, exp_activation, hidden_dtype,
                                    init_dense, init_predictor, resolve_weight_norm,
                                    storage_dtype)
from nero_tpu_torch.parallel.mesh import RayShard, draw_rows, rank_offset, sum_rows
from nero_tpu_torch.utils.color import linear_to_srgb
from nero_tpu_torch.utils.encodings import (ide_dim, integrated_dir_encode,
                                            integrated_pos_encode, positional_encode,
                                            positional_encode_dim)
from nero_tpu_torch.utils.sphere import az_el_to_points, sample_sphere

TWO_PI = 2.0 * math.pi


class MCShadingConfig(NamedTuple):
    diffuse_sample_num: int = 512
    specular_sample_num: int = 256
    human_lights: bool = True
    light_exp_max: float = 5.0
    inner_light_exp_max: float = 5.0
    outer_light_version: str = "direction"  # | "sphere_direction"
    geometry_type: str = "schlick"          # | "ggx_smith"
    reg_change: bool = True
    change_eps: float = 0.05
    change_type: str = "gaussian"
    reg_lambda1: float = 0.005
    reg_min_max: bool = True
    random_azimuth: bool = True
    is_real: bool = False
    ide_deg: int = 5
    # hidden activations of the material and light heads stored in bf16
    # inside `mc_shading_apply`; None = on for a CUDA model (`hidden_act_dtype`)
    bf16_hidden: bool | None = None
    # Hit-compacted inner-light evaluation: the traced HIT directions are
    # gathered into K = ceil-to-128(frac * pn * sn) static slots (stable
    # order), the inner-light MLP runs (fwd and bwd) only on those, and the
    # results scatter back over the miss-branch lights. Hits beyond capacity
    # keep the miss light. 0.0 = off (inner MLP on every direction).
    inner_compact_frac: float = 0.0
    # Miss-compacted outer-light evaluation, the mirror for concave scenes:
    # outer (+ human) light runs only on K compacted MISS slots; misses
    # beyond capacity keep zero light. Train-only. 0.0 = off.
    outer_compact_frac: float = 0.0
    # run the light heads with their IDE / PE encodings through the fused
    # kernel (ops/lights.py, forward and backward) instead of separate tensor
    # ops. None = off; True opts in where outer compaction is off and the
    # kernel takes the configuration (ops/lights.py::supported: ide_deg <= 5)
    # (with inner compaction on, the kernel runs the outer head only). Head
    # weights and their cotangents are bf16 inside the kernel.
    fused_lights: bool | None = None

    def hidden_act_dtype(self, device) -> torch.dtype:
        """The hidden storage dtype on `device`, by Stage I's rule
        (ops/mlp.py::storage_dtype; nero_tpu/fields/mc_shading.py:97-102)."""
        return storage_dtype(self.bf16_hidden, device)

    def resolved(self, device) -> "MCShadingConfig":
        return self._replace(bf16_hidden=self.hidden_act_dtype(device) == torch.bfloat16)


def mc_config_from_dict(cfg: dict) -> MCShadingConfig:
    """The MCShadingConfig of a config dict; an unknown `bf16_hidden` value
    raises ValueError."""
    fields = {k: v for k, v in cfg.items() if k in MCShadingConfig._fields}
    mcfg = MCShadingConfig(**fields)
    storage_dtype(mcfg.bf16_hidden, "cpu")
    return mcfg


def fused_lights_active(cfg: MCShadingConfig) -> bool:
    """Resolve cfg.fused_lights at apply time: None = off; True opts in where
    the configuration is one the kernel takes (outer compaction off and
    ops/lights.py::supported, the one rule of what the kernel takes), else
    warns (once, by the warnings module's default filter) and takes the
    unfused light path, which computes the same function. This is a rule
    about the configuration, never about the device."""
    if not cfg.fused_lights:
        return False
    if cfg.outer_compact_frac == 0.0 and lights_kernel_supported(cfg):
        return True
    warnings.warn("fused_lights=True was requested but the light kernel does not take "
                  f"this configuration (outer_compact_frac={cfg.outer_compact_frac}, "
                  f"ide_deg={cfg.ide_deg}); taking the unfused light path.",
                  RuntimeWarning, stacklevel=3)
    return False


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)


# ---------------------------------------------------------------------------
# Material feature network
# ---------------------------------------------------------------------------


def init_material_feats(gen: torch.Generator, device="cpu"):
    """PE(8) -> two 4x256 weight-norm blocks with a skip."""
    in_dim = positional_encode_dim(3, 8)
    run = 256
    dense = lambda di, do: init_dense(gen, di, do, device=device)
    m0 = [dense(in_dim, run), dense(run, run), dense(run, run), dense(run, run)]
    m1 = [dense(in_dim + run, run), dense(run, run), dense(run, run), dense(run, run)]
    return {"m0": m0, "m1": m1}


def material_feats_apply(params, x: torch.Tensor) -> torch.Tensor:
    enc = positional_encode(x, 8)
    h = enc
    for layer in params["m0"]:
        h = torch.relu(apply_dense(layer, h))
    h = torch.cat([h, enc], dim=-1)
    for i, layer in enumerate(params["m1"]):
        h = apply_dense(layer, h)
        if i < len(params["m1"]) - 1:
            h = torch.relu(h)
    return h


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_mc_shading(gen: torch.Generator, cfg: MCShadingConfig = MCShadingConfig(),
                    device="cpu"):
    sph = ide_dim(cfg.ide_deg)
    pos_dim = positional_encode_dim(3, 8)
    pred = lambda di, do, fb=None: init_predictor(gen, di, do, final_bias=fb, device=device)
    params = {
        "feats": init_material_feats(gen, device),
        "metallic": pred(256 + 3, 1),
        "roughness": pred(256 + 3, 1),
        "albedo": pred(256 + 3, 3),
        "outer_light": pred(sph * (2 if cfg.outer_light_version == "sphere_direction" else 1),
                            3, math.log(0.5)),
        "inner_light": pred(pos_dim + sph, 3, math.log(0.5)),
    }
    if cfg.human_lights:
        params["human_light"] = pred(2 * 2 * 6, 4, math.log(0.02))
    return params


def make_direction_samples(cfg: MCShadingConfig, device="cpu"):
    """Stratified Fibonacci-sphere (az, el) pairs scaled to [0,1]^2 (constants)."""
    def scaled(n):
        az, el = sample_sphere(n, 0)
        return np.stack([az * 0.5 / np.pi, 1 - 2 * el / np.pi], -1).astype(np.float32)
    az8, el8 = sample_sphere(8192, 0)
    return {
        "diffuse": torch.as_tensor(scaled(cfg.diffuse_sample_num), device=device),
        "specular": torch.as_tensor(scaled(cfg.specular_sample_num), device=device),
        "light_pts": torch.as_tensor(az_el_to_points(az8, el8).astype(np.float32),
                                     device=device),
    }


# ---------------------------------------------------------------------------
# Direction sampling
# ---------------------------------------------------------------------------


def get_orthogonal_directions(directions: torch.Tensor) -> torch.Tensor:
    x, y, z = directions[..., 0:1], directions[..., 1:2], directions[..., 2:3]
    zero = torch.zeros_like(x)
    otho0 = torch.cat([y, -x, zero], -1)
    otho1 = torch.cat([-z, zero, x], -1)
    use0 = (torch.linalg.norm(otho0, dim=-1, keepdim=True)
            > torch.linalg.norm(otho1, dim=-1, keepdim=True))
    otho = torch.where(use0, otho0, otho1)
    return otho / _norm(otho)


def _azimuth_rotation(n: int, like: torch.Tensor, gen, rot, shard=None):
    """Per-point azimuth rotation in [0, 2 pi): from the given uniform draws
    `rot` [n,1,1], else drawn from `gen`, else none."""
    if rot is None and gen is not None:
        rot = draw_rows(lambda shape: torch.rand(shape, generator=gen, device=like.device,
                                                 dtype=like.dtype), (n, 1, 1), shard)
    return None if rot is None else rot * TWO_PI


def sample_diffuse_directions(samples, normals, gen=None, rot=None, shard=None):
    """Cosine-hemisphere dirs around normals; [pn, sn, 3]."""
    z = normals
    x = get_orthogonal_directions(normals)
    y = torch.linalg.cross(z, x)
    az = samples[None, :, 0:1] * TWO_PI
    el = samples[None, :, 1:2]
    rot = _azimuth_rotation(normals.shape[0], normals, gen, rot, shard)
    if rot is not None:
        az = torch.remainder(az + rot, TWO_PI)
    el_sqrt = torch.sqrt(el + 1e-7)
    coeff_z = torch.sqrt(1 - el + 1e-7)
    coeff_x = el_sqrt * torch.cos(az)
    coeff_y = el_sqrt * torch.sin(az)
    return coeff_x * x[:, None] + coeff_y * y[:, None] + coeff_z * z[:, None]


def sample_specular_directions(samples, reflections, roughness, gen=None, rot=None,
                               shard=None):
    """GGX-importance dirs around reflections; roughness is already squared."""
    z = reflections
    x = get_orthogonal_directions(reflections)
    y = torch.linalg.cross(z, x)
    a = roughness[:, None]                      # [pn,1,1]
    az = samples[None, :, 0:1]
    el = samples[None, :, 1:2]
    phi = TWO_PI * az
    cos_theta = torch.sqrt((1.0 - el + 1e-6) / (1.0 + (a ** 2 - 1.0) * el + 1e-6) + 1e-6)
    sin_theta = torch.sqrt(1 - cos_theta ** 2 + 1e-6)
    rot = _azimuth_rotation(reflections.shape[0], reflections, gen, rot, shard)
    if rot is not None:
        phi = torch.remainder(phi + rot, TWO_PI)
    coeff_x = torch.cos(phi) * sin_theta
    coeff_y = torch.sin(phi) * sin_theta
    return coeff_x * x[:, None] + coeff_y * y[:, None] + cos_theta * z[:, None]


# ---------------------------------------------------------------------------
# BRDF terms
# ---------------------------------------------------------------------------


def saturate_dot(v0, v1):
    return torch.clamp(torch.sum(v0 * v1, dim=-1, keepdim=True), 0.0, 1.0)


def fresnel_schlick(F0, HoV):
    return F0 + (1.0 - F0) * torch.clamp(1.0 - HoV, 0.0, 1.0) ** 5.0


def distribution_ggx(NoH, roughness):
    a2 = roughness ** 2  # roughness is already alpha (= perceptual^2)
    denom = NoH ** 2 * (a2 - 1.0) + 1.0
    return a2 / (math.pi * denom ** 2 + 1e-4)


def geometry_schlick(NoV, NoL, roughness):
    def ggx(NoX):
        k = roughness / 2
        return NoX / (NoX * (1 - k) + k + 1e-5)
    return ggx(NoV) * ggx(NoL)


def geometry_ggx_smith(NoV, NoL, roughness):
    def lam(alpha2, cos_t):
        cos2 = cos_t ** 2
        tan2 = (1 - cos2) / (cos2 + 1e-7)
        return 0.5 * torch.sqrt(1 + alpha2 * tan2) - 0.5
    alpha2 = roughness ** 2
    return 1.0 / (1.0 + lam(alpha2, NoV) + lam(alpha2, NoL))


def geometry_term(cfg: MCShadingConfig, NoV, NoL, roughness):
    if cfg.geometry_type == "schlick":
        return geometry_schlick(NoV, NoL, roughness)
    if cfg.geometry_type == "ggx_smith":
        return geometry_ggx_smith(NoV, NoL, roughness)
    raise NotImplementedError(cfg.geometry_type)


# ---------------------------------------------------------------------------
# Lights
# ---------------------------------------------------------------------------


def predict_materials_mc(params, pts):
    feats = material_feats_apply(params["feats"], pts)
    inp = torch.cat([feats, pts], -1)
    metallic = apply_predictor(params["metallic"], inp)
    roughness = apply_predictor(params["roughness"], inp)
    rmax, rmin = 1.0, 0.04 ** 2
    roughness = roughness * (rmax - rmin) + rmin  # squared-roughness convention
    albedo = apply_predictor(params["albedo"], inp)
    return metallic, roughness, albedo


def get_inner_lights(params, cfg, points, view_dirs, normals):
    return apply_predictor(params["inner_light"],
                           inner_light_input(cfg, points, view_dirs, normals),
                           activation="exp", exp_max=cfg.inner_light_exp_max)


def get_human_light(params, points, directions, human_poses):
    inter, dists, hits = get_camera_plane_intersection(points, directions, human_poses)
    scale = 0.3
    mean = inter[..., :2] * scale
    hits = hits & (torch.linalg.norm(mean, dim=-1) < 1.5) & (dists > 0)
    hitsf = hits.to(mean.dtype)[..., None]
    mean = mean * hitsf
    var = torch.zeros_like(mean)
    pos_enc = integrated_pos_encode(mean, var, 0, 6)
    human = apply_predictor(params["human_light"], pos_enc, activation="exp",
                            exp_max=0.0) * hitsf
    return human[..., :3], torch.clamp(human[..., 3:], 0.0, 1.0)


def predict_outer_lights(params, cfg: MCShadingConfig, points, directions):
    return apply_predictor(params["outer_light"], outer_light_input(cfg, points, directions),
                           activation="exp", exp_max=cfg.light_exp_max)


def get_lights(params, cfg: MCShadingConfig, trace_fn, points, directions, human_poses,
               shard: RayShard | None = None):
    """Trace every sample direction; hit -> indirect MLP, miss -> env (+human).

    points/directions [pn,sn,3], human_poses [pn,sn,3,4] or None.
    Returns (lights [pn,sn,3], human_contrib, inters, normals, hit_mask)."""
    shape = points.shape[:-1]
    eps = 1e-5
    # the tracer is non-differentiable: everything it takes and returns is
    # detached
    flat_o = (points.reshape(-1, 3) + directions.reshape(-1, 3) * eps).detach()
    flat_d = directions.reshape(-1, 3).detach()
    inters, normals, depth, hit = (t.detach() for t in trace_fn(flat_o, flat_d))
    inters = inters.reshape(*shape, 3)
    normals = -normals.reshape(*shape, 3)   # NeuS-convention flip
    depth = depth.reshape(*shape, 1)
    hit = hit.reshape(*shape)

    # the fused light kernel (ops/lights.py): both heads when nothing is
    # compacted (the concave regime), the outer head only when inner
    # compaction is on; the final exp, the hit select and the human mixing
    # stay here
    inner_raw = None
    if fused_lights_active(cfg):
        mode = "outer" if cfg.inner_compact_frac > 0.0 else "both"
        inner_z, outer_z = lights_raw(params, cfg, points, directions, inters, normals,
                                      mode=mode)
        outer = exp_activation(outer_z, cfg.light_exp_max)
        if mode == "both":
            inner_raw = exp_activation(inner_z, cfg.inner_light_exp_max)
    elif cfg.outer_compact_frac == 0.0:
        outer = predict_outer_lights(params, cfg, points, directions)

    if cfg.outer_compact_frac > 0.0:
        miss_light, human_part = _compacted_miss_lights(params, cfg, points, directions,
                                                        human_poses, hit, shard)
    else:
        if cfg.human_lights:
            human_lights, human_weights = get_human_light(params, points, directions,
                                                          human_poses)
        else:
            human_lights = torch.zeros_like(outer)
            human_weights = torch.zeros_like(outer[..., :1])
        miss_light = outer * (1 - human_weights) + human_lights * human_weights
        human_part = human_lights * human_weights

    if cfg.inner_compact_frac > 0.0:
        lights = _compacted_inner_lights(params, cfg, inters, directions, normals, hit,
                                         miss_light, shard)
    else:
        inner = (inner_raw if inner_raw is not None
                 else get_inner_lights(params, cfg, inters, -directions, normals))
        lights = torch.where(hit[..., None], inner, miss_light)
    near_mask = (depth > eps).to(lights.dtype)
    lights = lights * near_mask  # a surface immediately in front emits nothing
    human_contrib = torch.where(hit[..., None], torch.zeros_like(human_part), human_part)
    return lights, human_contrib, inters, normals, hit


def _compaction(mask_flat: torch.Tensor, frac: float, shard: RayShard | None = None):
    """Static-capacity stable compaction of the True entries of `mask_flat`
    [n] into K = ceil-to-128(frac * n) slots. Returns (compact_src [K]: the
    flat index in each slot, stale 0 past the count; scatter_to [K]: the same
    with unfilled slots routed to the trash row n). With `shard`, K is of
    the global batch's entries and a rank keeps its selected entries whose
    global index is under K, in min(K, n) slots."""
    n = mask_flat.numel()
    n_all = n if shard is None else n // shard.n_local * shard.n
    k_all = min(-(-int(n_all * frac) // 128) * 128, n_all)
    k = min(k_all, n)
    dev = mask_flat.device
    rank = torch.cumsum(mask_flat, 0) - 1                # rank among the selected
    count = rank[-1] + 1
    slot = torch.where(mask_flat, torch.clamp(rank, max=k), torch.full_like(rank, k))
    # entries past capacity and unselected entries all land in trash slot k
    compact_src = torch.zeros(k + 1, dtype=torch.long, device=dev)
    compact_src[slot] = torch.arange(n, device=dev)
    compact_src = compact_src[:k]
    if shard is not None:
        # the global capacity left after the ranks before this one
        count = torch.minimum(count, torch.clamp(k_all - rank_offset(count, shard), min=0))
    valid = torch.arange(k, device=dev) < count
    scatter_to = torch.where(valid, compact_src, torch.full_like(compact_src, n))
    return compact_src, scatter_to


def _compacted_miss_lights(params, cfg, points, directions, human_poses, hit, shard=None):
    """Outer (+human) light on MISS directions only, via static compaction.
    Misses pack (stable order) into K slots; the outer MLP (+ human light)
    runs on the [K] batch and scatters back over a zero base. Misses beyond
    capacity keep zero light. Returns (miss_light, human_contrib) [pn,sn,3]."""
    shape = hit.shape
    n = hit.numel()
    compact_src, scatter_to = _compaction(~hit.reshape(-1), cfg.outer_compact_frac, shard)

    take = lambda a: a.reshape(n, -1)[compact_src]
    pts_k = take(points)
    dirs_k = take(directions)
    outer_k = predict_outer_lights(params, cfg, pts_k[:, None], dirs_k[:, None])[:, 0]
    if cfg.human_lights:
        hp_k = take(human_poses).reshape(-1, 1, 3, 4)
        human_k, hw_k = get_human_light(params, pts_k[:, None], dirs_k[:, None], hp_k)
        human_k, hw_k = human_k[:, 0], hw_k[:, 0]
        human_part_k = human_k * hw_k
        miss_k = outer_k * (1 - hw_k) + human_part_k
    else:
        human_part_k = torch.zeros_like(outer_k)
        miss_k = outer_k

    base = torch.zeros(n + 1, 3, dtype=miss_k.dtype, device=miss_k.device)
    miss_light = base.index_copy(0, scatter_to, miss_k)[:n]
    human_part = base.index_copy(0, scatter_to, human_part_k)[:n]
    return miss_light.reshape(*shape, 3), human_part.reshape(*shape, 3)


def _compacted_inner_lights(params, cfg, inters, directions, normals, hit, miss_light,
                            shard=None):
    """Inner-light MLP on hit directions only, via static-capacity
    compaction. Hits pack (stable order) into K slots; the MLP runs on the
    [K] batch and the results scatter back over the miss-branch lights. Hits
    beyond capacity keep the miss light; unfilled slots write to a trash row.
    The indices carry no gradient, so autograd sees a gather and a scatter
    around a [K]-batch MLP."""
    shape = hit.shape
    n = hit.numel()
    compact_src, scatter_to = _compaction(hit.reshape(-1), cfg.inner_compact_frac, shard)

    take = lambda a: a.reshape(n, -1)[compact_src]
    inner_k = get_inner_lights(params, cfg, take(inters), -take(directions), take(normals))
    lights = torch.cat([miss_light.reshape(n, 3), miss_light.new_zeros(1, 3)], dim=0)
    lights = lights.index_copy(0, scatter_to, inner_k)
    return lights[:n].reshape(*shape, 3)


# ---------------------------------------------------------------------------
# Mixed MIS estimator
# ---------------------------------------------------------------------------


def shade_mixed(params, cfg: MCShadingConfig, samples, trace_fn, pts, normals, view_dirs,
                reflections, metallic, roughness, albedo, human_poses, gen=None, rots=None,
                shard: RayShard | None = None):
    F0 = 0.04 * (1 - metallic) + metallic * albedo

    if not cfg.random_azimuth:
        gen, rots = None, None
    rot_d, rot_s = rots if rots is not None else (None, None)
    diffuse_dirs = sample_diffuse_directions(samples["diffuse"], normals, gen, rot_d, shard)
    specular_dirs = sample_specular_directions(samples["specular"], reflections, roughness,
                                               gen, rot_s, shard)
    dn = diffuse_dirs.shape[1]
    sn_ = specular_dirs.shape[1]
    total = dn + sn_

    NoL_d = saturate_dot(diffuse_dirs, normals[:, None])
    diffuse_prob = NoL_d / math.pi * (dn / total)

    H_s = view_dirs[:, None] + specular_dirs
    H_s = H_s / _norm(H_s)
    NoH_s = saturate_dot(normals[:, None], H_s)
    VoH_s = saturate_dot(view_dirs[:, None], H_s)
    specular_prob = (distribution_ggx(NoH_s, roughness[:, None]) * NoH_s
                     / (4 * VoH_s + 1e-5) * (sn_ / total))

    directions = torch.cat([diffuse_dirs, specular_dirs], 1)
    probability = torch.cat([diffuse_prob, specular_prob], 1)

    H = view_dirs[:, None] + directions
    H = H / _norm(H)
    HoV = saturate_dot(H, view_dirs[:, None])
    fresnel = fresnel_schlick(F0[:, None], HoV)
    NoV = saturate_dot(normals, view_dirs)[:, None]
    NoL = saturate_dot(normals[:, None], directions)
    geom = geometry_term(cfg, NoV, NoL, roughness[:, None])
    NoH = saturate_dot(normals[:, None], H)
    dist = distribution_ggx(NoH, roughness[:, None])

    hp = (human_poses[:, None].expand(pts.shape[0], total, 3, 4)
          if human_poses is not None else None)
    pts_rep = pts[:, None].expand(pts.shape[0], total, 3)
    lights, hl, _, _, _ = get_lights(params, cfg, trace_fn, pts_rep, directions, hp, shard)

    specular_weights = dist * geom / (4 * NoV * probability + 1e-5)
    specular_lights = lights * specular_weights
    specular_colors = torch.mean(fresnel * specular_lights, dim=1)

    kd = 1 - metallic[:, None]
    diffuse_lights = lights[:, :dn]
    diffuse_colors = torch.mean(albedo[:, None] * kd[:, :dn] * diffuse_lights, dim=1)

    colors = linear_to_srgb(diffuse_colors + specular_colors)

    clip01 = lambda x: torch.clamp(x, 0, 1)
    outputs = {
        "albedo": albedo,
        "roughness": roughness,
        "metallic": metallic,
        "human_lights": hl.reshape(-1, 3),
        "diffuse_light": clip01(linear_to_srgb(torch.mean(diffuse_lights, dim=1))),
        "specular_light": clip01(linear_to_srgb(torch.mean(specular_lights, dim=1))),
        "diffuse_color": clip01(linear_to_srgb(diffuse_colors)),
        "specular_color": clip01(linear_to_srgb(specular_colors)),
    }
    outputs["approximate_light"] = clip01(
        linear_to_srgb(torch.mean(kd[:, :dn] * diffuse_lights, dim=1))
        + outputs["specular_color"])
    return colors, outputs


def mc_shading_apply(params, cfg: MCShadingConfig, samples, trace_fn, pts, view_dirs, normals,
                     human_poses, gen=None, rots=None, shard: RayShard | None = None):
    """Full Stage-II shading. `gen` draws the per-point azimuth rotations
    (training); `rots` = (diffuse, specular) uniform draws [pn,1,1] replaces
    the draw; both None = no rotation (validation). Hidden activations in the
    storage dtype of `cfg` (nero_tpu/fields/mc_shading.py:583-591). With
    `shard` the points are this rank's rows of the global batch."""
    params = resolve_weight_norm(params)
    with hidden_dtype(cfg.hidden_act_dtype(pts.device)):
        view_dirs = view_dirs / _norm(view_dirs)
        normals = normals / _norm(normals)
        reflections = torch.sum(view_dirs * normals, -1, keepdim=True) * normals * 2 - view_dirs
        metallic, roughness, albedo = predict_materials_mc(params, pts)
        return shade_mixed(params, cfg, samples, trace_fn, pts, normals, view_dirs,
                           reflections, metallic, roughness, albedo, human_poses, gen, rots,
                           shard)


# ---------------------------------------------------------------------------
# Regularisers + environment export
# ---------------------------------------------------------------------------


def material_regularization(params, cfg: MCShadingConfig, gen, pts, normals, metallic,
                            roughness, albedo, step: int, draws=None,
                            shard: RayShard | None = None):
    """Material smoothness + early min/max clamping. `draws` = (uniform
    [pn,1], normal [pn,1]) replaces the draws from `gen`; the clamp sums over
    the (global) batch."""
    reg = torch.zeros(pts.shape[0], dtype=pts.dtype, device=pts.device)
    if cfg.reg_change:
        n = normals / _norm(normals)
        x = get_orthogonal_directions(n)
        y = torch.linalg.cross(n, x)
        if draws is None:
            shape, kw = (pts.shape[0], 1), dict(generator=gen, device=pts.device,
                                                dtype=pts.dtype)
            draws = (draw_rows(lambda s: torch.rand(s, **kw), shape, shard),
                     draw_rows(lambda s: torch.randn(s, **kw), shape, shard))
        ang = draws[0] * TWO_PI
        if cfg.change_type == "constant":
            change = (torch.cos(ang) * x + torch.sin(ang) * y) * cfg.change_eps
        elif cfg.change_type == "gaussian":
            change = (torch.cos(ang) * x + torch.sin(ang) * y) * (cfg.change_eps * draws[1])
        else:
            raise NotImplementedError(cfg.change_type)
        m0, r0, a0 = predict_materials_mc(params, pts + change)
        reg = reg + torch.mean(
            (torch.abs(m0 - metallic) + torch.abs(r0 - roughness) + torch.abs(a0 - albedo))
            * cfg.reg_lambda1, dim=1)

    if cfg.reg_min_max:
        relu = lambda v: torch.clamp(v, min=0.0)
        clamp = sum_rows(torch.sum(relu(roughness - 0.98 ** 2))
                         + torch.sum(relu(0.02 ** 2 - roughness))
                         + torch.sum(relu(metallic - 0.98)) + torch.sum(relu(0.02 - metallic)),
                         shard)
        reg = reg + clamp * float(step < 2000)
    return reg


def env_light_image(params, cfg: MCShadingConfig, h: int, w: int, gamma: bool = True,
                    device="cpu"):
    """Render the learned environment as a lat-long image [h,w,3]."""
    azs = torch.linspace(1.0, 0.0, w, device=device) * math.pi * 2 - math.pi / 2
    els = torch.linspace(1.0, -1.0, h, device=device) * math.pi / 2
    els, azs = torch.meshgrid(els, azs, indexing="ij")
    if cfg.is_real:
        x = torch.cos(els) * torch.cos(azs)
        y = torch.cos(els) * torch.sin(azs)
        z = torch.sin(els)
    else:
        z = torch.cos(els) * torch.cos(azs)
        x = torch.cos(els) * torch.sin(azs)
        y = torch.sin(els)
    xyz = torch.stack([x, y, z], -1).reshape(-1, 3)
    light = predict_outer_lights_pts(params, cfg, xyz)
    if gamma:
        light = linear_to_srgb(light)
    return light.reshape(h, w, 3)


def predict_outer_lights_pts(params, cfg: MCShadingConfig, pts):
    enc = integrated_dir_encode(pts, 0.0, cfg.ide_deg)
    if cfg.outer_light_version == "direction":
        return apply_predictor(params["outer_light"], enc, activation="exp",
                               exp_max=cfg.light_exp_max)
    if cfg.outer_light_version == "sphere_direction":
        return apply_predictor(params["outer_light"], torch.cat([enc, enc], -1),
                               activation="exp", exp_max=cfg.light_exp_max)
    raise NotImplementedError(cfg.outer_light_version)
