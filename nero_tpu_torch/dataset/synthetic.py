"""Procedural analytic test scene (no external data needed).

Renders a small multi-view dataset of a shiny sphere-like object inside the
unit sphere with an analytic environment — exact depth and geometry are
known, so integration tests and benchmarks can run end-to-end without the
GlossySynthetic download. Not present in the reference; this fills the role
of its packaged datasets for CI.
"""
from __future__ import annotations

import numpy as np

from nero_tpu_torch.utils.pose import look_at_pose


def _env_color(d: np.ndarray) -> np.ndarray:
    """Smooth directional environment light (linear RGB)."""
    r = 0.5 + 0.5 * np.sin(3.0 * d[..., 0]) * np.cos(2.0 * d[..., 1])
    g = 0.5 + 0.4 * d[..., 2]
    b = 0.5 + 0.5 * np.cos(2.5 * d[..., 0] + 1.0)
    return np.clip(np.stack([r, g, b], -1), 0.0, 1.0)


def _sphere_hit(o: np.ndarray, d: np.ndarray, radius: float):
    """Ray/sphere intersection; returns (t, hit_mask)."""
    b = np.sum(o * d, -1)
    c = np.sum(o * o, -1) - radius ** 2
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    hit = hit & (t > 0)
    return t, hit


# ---------------------------------------------------------------------------
# Concave SDF scene ("bowl"): an upward-opening hollow hemisphere shell with a
# small sphere resting inside. Two disjoint components, strong concavity,
# rim->interior self-shadowing and sphere<->bowl interreflection — the failure
# modes the reference exists for (cf. reference network/field.py:856-880
# indirect-light path) that a convex sphere can never exercise.
# ---------------------------------------------------------------------------

BOWL_SHELL_R = 0.42
BOWL_SHELL_TH = 0.03
BOWL_RIM_Z = 0.15
BOWL_BALL_C = np.asarray([0.0, 0.0, -0.23])
BOWL_BALL_R = 0.16


def _sdf_bowl(p: np.ndarray) -> np.ndarray:
    """Exact-enough SDF of the bowl+ball scene; p [...,3] -> [...]."""
    r = np.linalg.norm(p, axis=-1)
    shell = np.abs(r - BOWL_SHELL_R) - BOWL_SHELL_TH
    bowl = np.maximum(shell, p[..., 2] - BOWL_RIM_Z)
    ball = np.linalg.norm(p - BOWL_BALL_C, axis=-1) - BOWL_BALL_R
    return np.minimum(bowl, ball)


# ---------------------------------------------------------------------------
# Mirror-grade scene ("mirror"): a thin-tube torus (genus 1 — the hardest mesh
# family for a distilled visibility field) plus a polished ball threaded
# through its hole, both near-perfect mirrors (metallic~1, roughness~0.05).
# Two reflection bounces: the torus sees the ball sees the torus — sharper
# interreflection than the bowl, where visibility errors actually show
# (cf. reference configs/shape/syn/angel.yaml's clip_sample_variance hard
# cases).
# ---------------------------------------------------------------------------

TORUS_R = 0.34          # major radius
TORUS_TUBE = 0.055      # minor (tube) radius — thin
MIRROR_BALL_C = np.asarray([0.0, 0.0, 0.0])
MIRROR_BALL_R = 0.14


def _sdf_mirror(p: np.ndarray) -> np.ndarray:
    q = np.stack([np.linalg.norm(p[..., :2], axis=-1) - TORUS_R, p[..., 2]], -1)
    torus = np.linalg.norm(q, axis=-1) - TORUS_TUBE
    ball = np.linalg.norm(p - MIRROR_BALL_C, axis=-1) - MIRROR_BALL_R
    return np.minimum(torus, ball)


def scene_sdf(kind: str):
    """Analytic SDF of a procedural scene kind (for gt meshes / tracer tests)."""
    if kind == "sphere":
        return lambda p: np.linalg.norm(p, axis=-1) - 0.5
    if kind in ("bowl", "capture"):
        return _sdf_bowl
    if kind == "mirror":
        return _sdf_mirror
    raise NotImplementedError(f"unknown procedural kind {kind}")


def _sdf_normal(sdf, p: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    n = np.stack([
        sdf(p + np.asarray([eps, 0, 0])) - sdf(p - np.asarray([eps, 0, 0])),
        sdf(p + np.asarray([0, eps, 0])) - sdf(p - np.asarray([0, eps, 0])),
        sdf(p + np.asarray([0, 0, eps])) - sdf(p - np.asarray([0, 0, eps])),
    ], -1)
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)


def _sphere_trace(sdf, o, d, t_min, t_max, iters: int = 160, tol: float = 2e-4):
    """Vectorized sphere tracing; returns (t, hit_mask)."""
    t = np.full(o.shape[:-1], t_min, np.float64) if np.isscalar(t_min) \
        else t_min.astype(np.float64).copy()
    hit = np.zeros(o.shape[:-1], bool)
    active = np.ones(o.shape[:-1], bool)
    for _ in range(iters):
        if not active.any():
            break
        p = o[active] + d[active] * t[active][:, None]
        dist = sdf(p)
        converged = dist < tol
        idx = np.where(active)[0]
        hit[idx[converged]] = True
        t[active] = t[active] + np.maximum(dist, 0.0) * 0.95
        still = ~converged & (t[active] < (t_max if np.isscalar(t_max) else t_max[active]))
        new_active = np.zeros_like(active)
        new_active[idx[still]] = True
        active = new_active
    return t, hit


def _shadow_factor(sdf, p, n, light_dir, t_max: float = 2.0):
    """Hard visibility toward a directional light (self-shadowing)."""
    o = p + n * 2e-3
    d = np.broadcast_to(light_dir, o.shape)
    _, occluded = _sphere_trace(sdf, o, d, 5e-3, t_max, iters=96)
    return (~occluded).astype(np.float64)


def _bowl_albedo(p: np.ndarray) -> np.ndarray:
    """Component-coloured patterned albedo (texture signal for the SDF fit)."""
    in_ball = np.linalg.norm(p - BOWL_BALL_C, axis=-1) - BOWL_BALL_R < \
        np.abs(np.linalg.norm(p, axis=-1) - BOWL_SHELL_R) - BOWL_SHELL_TH
    bowl_col = 0.40 + 0.25 * np.stack([
        np.sin(9 * p[:, 0]) * np.sin(7 * p[:, 1]),
        np.cos(8 * p[:, 2] + 0.5),
        np.sin(6 * p[:, 1] - 1.0),
    ], -1)
    ball_col = np.stack([
        0.25 + 0.1 * np.sin(12 * p[:, 2]),
        0.3 + 0.1 * np.cos(10 * p[:, 0]),
        0.65 + 0.2 * np.sin(11 * p[:, 1]),
    ], -1)
    return np.where(in_ball[:, None], ball_col, bowl_col)


_LIGHT_DIR = np.asarray([0.35, 0.25, 0.9]) / np.linalg.norm([0.35, 0.25, 0.9])


def _shade_bowl(p, n, d, depth_left: int = 1):
    """Direct light with shadow rays + fresnel reflection (one bounce)."""
    sdf = _sdf_bowl
    albedo = _bowl_albedo(p)
    shadow = _shadow_factor(sdf, p, n, _LIGHT_DIR)
    lambert = np.clip(np.sum(n * _LIGHT_DIR, -1), 0, 1) * shadow
    color = albedo * (0.18 + 0.82 * lambert[:, None])
    nov = np.clip(-np.sum(d * n, -1, keepdims=True), 0, 1)
    fresnel = 0.06 + 0.94 * (1 - nov) ** 5
    refl = d - 2 * np.sum(d * n, -1, keepdims=True) * n
    if depth_left > 0:
        o2 = p + n * 2e-3
        t2, hit2 = _sphere_trace(sdf, o2, refl, 5e-3, 2.5)
        refl_col = _env_color(refl)
        if hit2.any():
            p2 = o2[hit2] + refl[hit2] * t2[hit2][:, None]
            n2 = _sdf_normal(sdf, p2)
            refl_col[hit2] = _shade_bowl(p2, n2, refl[hit2], depth_left - 1)
    else:
        refl_col = _env_color(refl)
    return color + 0.5 * fresnel * refl_col


def _mirror_albedo(p: np.ndarray) -> np.ndarray:
    """Dark metal tint with a faint pattern (most signal is the reflection)."""
    in_ball = (np.linalg.norm(p - MIRROR_BALL_C, axis=-1) - MIRROR_BALL_R) < \
        _sdf_mirror(p) + 1e-6  # closer to the ball component
    gold = np.stack([0.85 + 0.05 * np.sin(10 * p[:, 0]),
                     0.65 + 0.05 * np.cos(9 * p[:, 2]),
                     0.30 + 0.05 * np.sin(8 * p[:, 1])], -1)
    steel = np.stack([0.72 + 0.04 * np.cos(11 * p[:, 2]),
                      0.75 + 0.04 * np.sin(9 * p[:, 0]),
                      0.80 + 0.04 * np.cos(10 * p[:, 1])], -1)
    return np.where(in_ball[:, None], gold, steel)


def _shade_mirror(p, n, d, depth_left: int = 2):
    """Near-perfect mirror: tiny diffuse floor + strong multi-bounce specular."""
    sdf = _sdf_mirror
    albedo = _mirror_albedo(p)
    lambert = np.clip(np.sum(n * _LIGHT_DIR, -1), 0, 1)
    diffuse = albedo * 0.06 * (0.3 + 0.7 * lambert[:, None])
    refl = d - 2 * np.sum(d * n, -1, keepdims=True) * n
    refl_col = _env_color(refl)
    if depth_left > 0:
        o2 = p + n * 2e-3
        t2, hit2 = _sphere_trace(sdf, o2, refl, 5e-3, 2.5)
        if hit2.any():
            p2 = o2[hit2] + refl[hit2] * t2[hit2][:, None]
            n2 = _sdf_normal(sdf, p2)
            refl_col[hit2] = _shade_mirror(p2, n2, refl[hit2], depth_left - 1)
    # tinted conductor fresnel (metallic F0 = albedo)
    nov = np.clip(-np.sum(d * n, -1, keepdims=True), 0, 1)
    f = albedo + (1 - albedo) * (1 - nov) ** 5
    return diffuse + 0.94 * f * refl_col


# camera-collocated capture light ("capture" scene): same bowl geometry, but
# shaded with an extra point light riding the camera — the physical situation
# the reference's human_light head models for GlossyReal captures
# (reference network/field.py:536-552, configs/shape/real/bear.yaml:7).
_CAPTURE_LIGHT_I = 1.4


def _shade_capture(p, n, d, cam_pos):
    base = _shade_bowl(p, n, d)
    to_cam = cam_pos[None, :] - p
    dist = np.linalg.norm(to_cam, axis=-1, keepdims=True)
    l = to_cam / np.maximum(dist, 1e-9)
    # the light sits at the camera: primary visibility == light visibility,
    # so no shadow ray is needed along this path
    ndl = np.clip(np.sum(n * l, -1, keepdims=True), 0, 1)
    half = l - d
    half = half / np.maximum(np.linalg.norm(half, axis=-1, keepdims=True), 1e-9)
    spec = np.clip(np.sum(n * half, -1, keepdims=True), 0, 1) ** 48
    cam_light = _CAPTURE_LIGHT_I / np.maximum(dist ** 2, 1e-6)
    return base + cam_light * (_bowl_albedo(p) * 0.35 * ndl + 0.5 * spec)


def _camera_rays(pose, K, h, w):
    xs, ys = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3)
    K_inv = np.linalg.inv(K)
    d_cam = pix @ K_inv.T
    d_cam_norm = np.linalg.norm(d_cam, axis=-1)
    R = pose[:, :3]
    t = pose[:, 3]
    d = d_cam @ R  # R^T d
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(-R.T @ t, d.shape)
    return o, d, d_cam_norm


def _render_sdf_view(pose, K, h, w, sdf, shade_fn):
    """SDF-traced render with shadows + interreflection (shared by the bowl /
    mirror / capture scene kinds)."""
    o, d, d_cam_norm = _camera_rays(pose, K, h, w)
    cam_pos = o[0].copy()
    cam_dist = np.linalg.norm(cam_pos)
    t_hit, hit = _sphere_trace(sdf, o, d, cam_dist - 1.0, cam_dist + 1.0)

    rgb = _env_color(d)
    if hit.any():
        p = o[hit] + d[hit] * t_hit[hit][:, None]
        n = _sdf_normal(sdf, p)
        rgb[hit] = shade_fn(p, n, d[hit], cam_pos)
    rgb = np.clip(rgb, 0, 1) ** (1 / 2.2)

    depth = np.where(hit, t_hit / d_cam_norm, 15.0).astype(np.float32)
    img = (np.clip(rgb, 0, 1) * 255 + 0.5).astype(np.uint8)
    return img.reshape(h, w, 3), depth.reshape(h, w), hit.reshape(h, w)


def render_view_bowl(pose: np.ndarray, K: np.ndarray, h: int, w: int):
    """SDF-traced render of the concave scene with shadows + interreflection."""
    return _render_sdf_view(pose, K, h, w, _sdf_bowl,
                            lambda p, n, d, cam: _shade_bowl(p, n, d))


def render_view(pose: np.ndarray, K: np.ndarray, h: int, w: int,
                radius: float = 0.5, kind: str = "sphere"):
    """Analytic render: lambertian+specular object on an env background.

    Returns (rgb uint8 [h,w,3], depth float32 [h,w], mask bool [h,w]).
    """
    if kind == "bowl":
        return render_view_bowl(pose, K, h, w)
    if kind == "mirror":
        return _render_sdf_view(pose, K, h, w, _sdf_mirror,
                                lambda p, n, d, cam: _shade_mirror(p, n, d))
    if kind == "capture":
        return _render_sdf_view(pose, K, h, w, _sdf_bowl,
                                lambda p, n, d, cam: _shade_capture(p, n, d, cam))
    o, d, d_cam_norm = _camera_rays(pose, K, h, w)

    t_hit, hit = _sphere_hit(o, d, radius)
    p = o + d * t_hit[:, None]
    n = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-9)

    # bumpy albedo so the SDF has texture signal to latch onto
    albedo = 0.35 + 0.3 * np.stack([
        np.sin(7 * p[:, 0]) * np.sin(5 * p[:, 1]),
        np.sin(6 * p[:, 1] + 1.0),
        np.cos(8 * p[:, 2]),
    ], -1)

    light_dir = np.asarray([0.4, 0.3, 0.85])
    light_dir = light_dir / np.linalg.norm(light_dir)
    lambert = np.clip(np.sum(n * light_dir, -1, keepdims=True), 0, 1)
    refl = d - 2 * np.sum(d * n, -1, keepdims=True) * n
    spec_env = _env_color(refl)
    nov = np.clip(-np.sum(d * n, -1, keepdims=True), 0, 1)
    fresnel = 0.04 + 0.96 * (1 - nov) ** 5
    color_obj = albedo * (0.25 + 0.75 * lambert) + 0.6 * fresnel * spec_env

    color_bg = _env_color(d)
    rgb = np.where(hit[:, None], color_obj, color_bg)
    rgb = np.clip(rgb, 0, 1) ** (1 / 2.2)  # simple gamma for display range

    # store pinhole z-depth (t is a distance along the unit ray; camera-space
    # unit-ray z equals 1/||K^-1 p||) so mask_depth_to_pts backprojects exactly
    depth = np.where(hit, t_hit / d_cam_norm, 15.0).astype(np.float32)
    img = (np.clip(rgb, 0, 1) * 255 + 0.5).astype(np.uint8)
    return img.reshape(h, w, 3), depth.reshape(h, w), hit.reshape(h, w)


def make_cameras(n_views: int, h: int, w: int, dist: float = 3.0, seed: int = 0,
                 el_range: tuple = (0.25, 0.75)):
    """Ring + elevation jitter cameras looking at the origin."""
    rng = np.random.RandomState(seed)
    Ks, poses = [], []
    f = 1.1 * max(h, w)
    K = np.asarray([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    for i in range(n_views):
        az = 2 * np.pi * i / n_views
        el = el_range[0] + (el_range[1] - el_range[0]) * rng.rand()
        eye = dist * np.asarray([np.cos(az) * np.cos(el),
                                 np.sin(az) * np.cos(el),
                                 np.sin(el)])
        poses.append(look_at_pose(eye, np.zeros(3)))
        Ks.append(K.copy())
    return np.stack(Ks), np.stack(poses)
