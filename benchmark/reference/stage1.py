"""One scene's Stage-I training steps, plain torch: the ray batch, NeuS's
hierarchical sampling, the render, the losses, Adam.

`run_steps` takes what the benchmark made (the parameters at the first
step, the scene's photos, cameras and the state of the step's generator)
and takes `n` steps from the cell's first step index. Its random draws are
those the program makes, in the same order and of the same shapes, so a
generator in the same state gives both sides the same rays and jitter.
"""
from __future__ import annotations

import contextlib
import math

import torch

from benchmark.reference import fields
from benchmark.reference.fields import (bg_nerf_apply, linear_to_srgb, resolve_tree,
                                        sdf_value, sdf_with_grad, shade)

# the keys of a configuration file that the reference reads, with the
# defaults NeRO's shape network gives them where the file leaves them out
DEFAULTS = {"train_ray_num": 512, "n_samples": 64, "n_importance": 64, "n_bg_samples": 32,
            "up_sample_steps": 4, "anneal_end": 50000, "inv_s_init": 0.3,
            "freeze_inv_s_step": None, "sdf_freq": 6, "occ_loss_step": 20000,
            "occ_loss_max_pn": 2048, "occ_sdf_thresh": 0.01, "eikonal_weight": 0.1,
            "apply_occ_loss": True, "clip_sample_variance": True, "total_step": 300000,
            "fixed_camera": False, "rgb_loss": "charbonier"}
SUPPORTED_LOSSES = ("nerf_render", "eikonal", "std", "init_sdf_reg", "occ")


def settings(cfg: dict) -> dict:
    s = {**DEFAULTS, **{k: v for k, v in cfg.items() if k in DEFAULTS}}
    s["shader"] = dict(cfg.get("shader_config") or {})
    if s["rgb_loss"] != "charbonier" or any(l not in SUPPORTED_LOSSES for l in cfg["loss"]):
        raise NotImplementedError("the reference follows NeRO Stage I's losses only")
    return s


@contextlib.contextmanager
def exact_float32():
    """float32 products with TF32 off, restored on exit."""
    m = torch.backends.cuda.matmul
    if hasattr(m, "fp32_precision"):
        was = m.fp32_precision
        m.fp32_precision = "ieee"
        try:
            yield
        finally:
            m.fp32_precision = was
    else:
        was = m.allow_tf32
        m.allow_tf32 = False
        try:
            yield
        finally:
            m.allow_tf32 = was


# ---------------------------------------------------------------------------
# rays
# ---------------------------------------------------------------------------

def near_far(rays_o, rays_d):
    a = torch.sum(rays_d ** 2, dim=-1, keepdim=True)
    b = 2.0 * torch.sum(rays_o * rays_d, dim=-1, keepdim=True)
    mid = 0.5 * (-b) / a
    return torch.clamp(mid - 1.0, min=1e-3), mid + 1.0


def human_poses(poses: torch.Tensor, fixed_camera: bool) -> torch.Tensor:
    """Each camera's 'human' frame [N, 3, 4]: Y = world -z, Z = the camera's
    viewing axis flattened to the ground, origin under the camera."""
    R_w2c = poses[..., :3, :3]
    cen = -torch.einsum("...ji,...j->...i", R_w2c, poses[..., :3, 3])
    if not fixed_camera:
        cen = torch.cat([cen[..., :2], torch.zeros_like(cen[..., 2:])], dim=-1)
    n = poses.shape[0]
    Y = torch.tensor([0.0, 0.0, -1.0], dtype=poses.dtype, device=poses.device).expand(n, 3)
    Z = torch.cat([poses[:, 2, :2], torch.zeros_like(poses[:, 2, 2:3])], dim=-1)
    Z = Z / torch.clamp(torch.linalg.norm(Z, dim=-1, keepdim=True), min=1e-12)
    R = torch.stack([torch.linalg.cross(Y, Z), Y, Z], dim=1)
    return torch.cat([R, -torch.einsum("nij,nj->ni", R, cen)[:, :, None]], dim=-1)


def scene_tensors(scene: dict, device, fixed_camera: bool) -> dict:
    """The photos (uint8 [N, H, W, 3]), inverse intrinsics and w2c poses on
    the device, with each camera's human frame."""
    poses = torch.as_tensor(scene["poses"], dtype=torch.float32, device=device)
    Ks = torch.as_tensor(scene["Ks"], dtype=torch.float32, device=device)
    return {"imgs": torch.as_tensor(scene["imgs"], device=device),
            "K_inv": torch.linalg.inv(Ks), "poses": poses,
            "human": human_poses(poses, fixed_camera)}


def ray_batch(gen, d: dict, n: int) -> dict:
    """n uniform random pixels over all photos, drawn as the program draws."""
    imgs = d["imgs"]
    N, h, w, _ = imgs.shape
    idx = torch.randint(0, N * h * w, (n,), generator=gen, device=imgs.device)
    img_i, pix = idx // (h * w), idx % (h * w)
    py, px = pix // w, pix % w
    homo = torch.stack([px.float() + 0.5, py.float() + 0.5, torch.ones_like(px.float())], -1)
    d_cam = torch.einsum("...ij,...j->...i", d["K_inv"][img_i], homo)
    R, t = d["poses"][img_i][..., :3, :3], d["poses"][img_i][..., :3, 3]
    rays_d = torch.einsum("...ji,...j->...i", R, d_cam)
    rays_d = rays_d / torch.clamp(torch.linalg.norm(rays_d, dim=-1, keepdim=True), min=1e-12)
    rays_o = torch.broadcast_to(-torch.einsum("...ji,...j->...i", R, t), rays_d.shape)
    near, far = near_far(rays_o, rays_d)
    return {"rays_o": rays_o, "rays_d": rays_d, "near": near, "far": far,
            "rgb": imgs[img_i, py, px].float() / 255.0, "human": d["human"][img_i]}


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def sample_pdf(bins, weights, n):
    """Deterministic inverse-CDF samples at the mid-quantiles."""
    weights = weights + 1e-5
    cdf = torch.cumsum(weights / torch.sum(weights, -1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    u = torch.linspace(0.5 / n, 1.0 - 0.5 / n, n, dtype=cdf.dtype, device=cdf.device)
    u = u.expand(cdf.shape[:-1] + (n,)).contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    c0, c1 = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    b0, b1 = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    denom = torch.where(c1 - c0 < 1e-5, torch.ones_like(c1), c1 - c0)
    return b0 + (u - c0) / denom * (b1 - b0)


def _composite(alpha):
    return alpha * torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]),
                                            1.0 - alpha + 1e-7], -1), -1)[..., :-1]


def _upsample(rays_o, rays_d, z, sdf, n_new, inv_s):
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    radius = torch.linalg.norm(pts, dim=-1)
    inside = (radius[:, :-1] < 1.0) | (radius[:, 1:] < 1.0)
    mid = (sdf[:, :-1] + sdf[:, 1:]) * 0.5
    cos = (sdf[:, 1:] - sdf[:, :-1]) / (z[:, 1:] - z[:, :-1] + 1e-5)
    cos = torch.minimum(torch.cat([torch.zeros_like(cos[:, :1]), cos[:, :-1]], -1), cos)
    cos = torch.clamp(cos, -1e3, 0.0) * inside.to(sdf.dtype)
    dist = z[:, 1:] - z[:, :-1]
    prev_cdf = torch.sigmoid((mid - cos * dist * 0.5) * inv_s)
    next_cdf = torch.sigmoid((mid + cos * dist * 0.5) * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    return sample_pdf(z, _composite(alpha), n_new)


@torch.no_grad()
def sample_z(P, s, gen, rays_o, rays_d, near, far, mode):
    """Inner z [R, n_samples + n_importance], background z [R, n_bg]."""
    r, sn, nb = rays_o.shape[0], s["n_samples"], s["n_bg_samples"]
    dev = rays_o.device
    z = near + (far - near) * torch.linspace(0.0, 1.0, sn, device=dev)[None, :]
    z_lin = torch.linspace(1e-3, 1.0 - 1.0 / (nb + 1.0), nb, device=dev)
    z = z + (torch.rand((r, 1), generator=gen, device=dev) - 0.5) * 2.0 / sn
    mids = 0.5 * (z_lin[1:] + z_lin[:-1])
    upper, lower = torch.cat([mids, z_lin[-1:]]), torch.cat([z_lin[:1], mids])
    z_out = lower[None, :] + (upper - lower)[None, :] * torch.rand((r, nb), generator=gen,
                                                                    device=dev)
    z_bg = far / torch.flip(z_out, dims=[-1]) + 1.0 / nb
    n_new = s["n_importance"] // s["up_sample_steps"]
    base_inv_s = torch.exp(P["variance"]["variance"] * 10.0)
    f = lambda z_: sdf_value(P["sdf"], rays_o[:, None, :] + rays_d[:, None, :] * z_[..., None],
                             s["sdf_freq"], mode)[..., 0]
    sdf = f(z)
    for i in range(s["up_sample_steps"]):
        inv_s = (torch.clamp(base_inv_s, max=64.0 * 2 ** i) if s["clip_sample_variance"]
                 else torch.tensor(64.0 * 2 ** i, device=dev))
        new_z = _upsample(rays_o, rays_d, z, sdf, n_new, inv_s)
        z_cat = torch.cat([z, new_z], -1)
        if i + 1 < s["up_sample_steps"]:
            z, order = torch.sort(z_cat, dim=-1, stable=True)
            sdf = torch.gather(torch.cat([sdf, f(new_z)], -1), -1, order)
        else:
            z = torch.sort(z_cat, dim=-1, stable=True).values
    return z, z_bg


# ---------------------------------------------------------------------------
# occlusion loss
# ---------------------------------------------------------------------------

def _sphere_exit(pts, dirs):
    dtx = torch.sum(pts * dirs, -1, keepdim=True)
    dist = dtx ** 2 - torch.sum(pts ** 2, -1, keepdim=True) + 1.0
    return -dtx + torch.sqrt(torch.clamp(dist, min=0.0) + 1e-6)


def _march_weights(sdf_fn, inv_s, z, origins, dirs):
    sdf = sdf_fn(origins[:, None, :] + dirs[:, None, :] * z[..., None])[..., 0]
    mid = (sdf[:, :-1] + sdf[:, 1:]) * 0.5
    cos = (sdf[:, 1:] - sdf[:, :-1]) / (z[:, 1:] - z[:, :-1] + 1e-5)
    surface = cos < 0
    cos = torch.clamp(cos, max=0.0)
    dist = z[:, 1:] - z[:, :-1]
    prev_cdf = torch.sigmoid((mid - cos * dist * 0.5) * inv_s)
    next_cdf = torch.sigmoid((mid + cos * dist * 0.5) * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5) * surface.to(sdf.dtype)
    return _composite(alpha)


@torch.no_grad()
def occlusion_truth(sdf_fn, inv_s, pts, dirs, sn0=64, sn1=16):
    """The probability that the ray from each point along `dirs` meets the
    surface before the unit sphere: a two-pass importance march."""
    inside = torch.linalg.norm(pts, dim=-1) < 0.999
    pts = torch.where(inside[:, None], pts, torch.zeros_like(pts))
    z = _sphere_exit(pts, dirs) * torch.linspace(0.0, 1.0, sn0, device=pts.device)[None, :]
    z = sample_pdf(z, _march_weights(sdf_fn, inv_s, z, pts, dirs), sn1)
    w = _march_weights(sdf_fn, inv_s, z, pts, dirs)
    return torch.sum(torch.where(inside[:, None], w, torch.zeros_like(w)), -1)


def occ_candidates(points, sdf, grads, dirs, thresh):
    """The samples the occlusion loss may pick: inside the unit sphere, near
    the surface, on a face towards the camera."""
    return ((torch.linalg.norm(points, dim=-1) < 0.999) & (torch.abs(sdf) < thresh)
            & (torch.sum(grads * dirs, -1) < 0.0))


def occ_loss(P, s, gen, points, reflective, occ_prob, sdf, grads, dirs, mode):
    """Mean |occ_prob - traced truth| over up to max_pn // R masked
    candidates a ray, picked by a random score."""
    r, n = points.shape[:2]
    with torch.no_grad():
        mask = occ_candidates(points, sdf, grads, dirs, s["occ_sdf_thresh"])
        rand = torch.rand((r, n), generator=gen, device=points.device)
        score = torch.where(mask, rand, torch.full_like(rand, -1.0))
        k = max(1, min(s["occ_loss_max_pn"] // r, n))
        top, idx = torch.topk(score, k, dim=-1)
        valid = (top > 0.0).reshape(-1).float()
        idx3 = idx[..., None].expand(r, k, 3)
        pts_k = torch.gather(points, 1, idx3).reshape(r * k, 3)
        refl_k = torch.gather(reflective.detach(), 1, idx3).reshape(r * k, 3)
        inv_s = torch.exp(P["variance"]["variance"] * 10.0)
        truth = occlusion_truth(lambda x: sdf_value(P["sdf"], x, s["sdf_freq"], mode), inv_s,
                                pts_k, refl_k)
    occ_k = torch.gather(occ_prob, 1, idx).reshape(r * k)
    return (torch.abs(occ_k - truth) * valid).sum() / torch.clamp(valid.sum(), min=1.0)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def losses(P, s, lut, batch, step: int, gen, mode: str) -> dict:
    """The step's loss terms (each a scalar), as NeRO's shape network sums them."""
    P = resolve_tree(P)
    rays_o, rays_d = batch["rays_o"], batch["rays_d"]
    z_in, z_bg = sample_z(P, s, gen, rays_o, rays_d, batch["near"], batch["far"], mode)
    z = torch.cat([z_in, z_bg], -1)
    r, n_all = z.shape
    n_in = s["n_samples"] + s["n_importance"]
    car = 1.0 if s["anneal_end"] < 0 else min(1.0, step / s["anneal_end"])
    dists = z[..., 1:] - z[..., :-1]
    dists = torch.cat([dists, dists[..., -1:]], -1)
    points = rays_o[:, None, :] + rays_d[:, None, :] * (z + dists * 0.5)[..., None]
    inner = torch.linalg.norm(points, dim=-1) <= 1.0
    dirs = rays_d[:, None, :].expand(points.shape)
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12)

    # background on the outer samples
    p_out, d_out = points[:, n_in:], dists[:, n_in:]
    norm = torch.clamp(torch.linalg.norm(p_out, dim=-1, keepdim=True), min=1e-3)
    density, color = bg_nerf_apply(P["bg"], torch.cat([p_out / norm, 1.0 / norm], -1),
                                   -dirs[:, n_in:], mode)
    alpha_out = 1.0 - torch.exp(-torch.nn.functional.softplus(density[..., 0]) * d_out)
    color_out = linear_to_srgb(torch.exp(torch.clamp(color, max=5.0)))
    alpha_bg = torch.cat([alpha_out.new_zeros((r, n_in)), alpha_out], 1)
    color_bg = torch.cat([color_out.new_zeros((r, n_in, 3)), color_out], 1)

    # the SDF on the inner lattice, NeuS alpha
    pts_in, dists_in, dirs_in = points[:, :n_in], dists[:, :n_in], dirs[:, :n_in]
    sdf, feats, grads = sdf_with_grad(P["sdf"], pts_in, s["sdf_freq"], mode)
    sdf = sdf[..., 0]
    inv_s = torch.clamp(torch.exp(P["variance"]["variance"] * 10.0), 1e-6, 1e6)
    if s["freeze_inv_s_step"] is not None and step < s["freeze_inv_s_step"]:
        inv_s = inv_s.detach()
    true_cos = torch.sum(dirs_in * grads, -1)
    iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - car) + torch.relu(-true_cos) * car)
    prev_cdf = torch.sigmoid((sdf - iter_cos * dists_in * 0.5) * inv_s)
    next_cdf = torch.sigmoid((sdf + iter_cos * dists_in * 0.5) * inv_s)
    alpha_sdf = torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)
    inner_in = inner[:, :n_in]
    alpha = torch.cat([torch.where(inner_in, alpha_sdf, alpha_bg[:, :n_in]),
                       alpha_bg[:, n_in:]], 1)
    weights = _composite(alpha)
    mask_sdf = torch.cat([inner_in, inner_in.new_zeros((r, n_all - n_in))], 1)
    rgb = torch.sum(color_bg * (weights * ~mask_sdf)[..., None], 1)

    hp = batch["human"][:, None].expand(r, n_in, 3, 4)
    color_in, reflective, occ_prob = shade(P["shader"], s["shader"], lut, pts_in, grads,
                                           -dirs_in, feats, hp, mode)
    rgb = rgb + torch.sum(color_in * (weights[:, :n_in] * inner_in)[..., None], 1)

    out = {"loss_rgb": torch.sqrt(torch.sum((batch["rgb"] - rgb) ** 2, -1) + 0.001).mean()}
    grad_err = (torch.linalg.norm(grads, dim=-1) - 1.0) ** 2
    out["loss_eikonal"] = ((grad_err * inner_in).sum() / torch.clamp(inner_in.sum(), min=1.0)
                           * s["eikonal_weight"])
    # the sphere prior of the first 1,000 steps (zero later, as in NeRO)
    norm_in = torch.linalg.norm(pts_in, dim=-1).reshape(-1)
    sdf_flat = sdf.reshape(-1)
    small = (norm_in < 0.1).float()
    small_mean = ((torch.clamp(sdf_flat - (norm_in - 0.1), min=0.0) * small).sum()
                  / torch.clamp(small.sum(), min=1.0))
    large = (norm_in > 1.05).float()
    large_vec = torch.clamp((norm_in - 1.05) - sdf_flat, min=0.0) * large
    large_loss = large_vec.sum() / ((large_vec > 1e-5).float().sum() + 1e-3)
    anneal = (math.cos(min(max(step / 1000, 0.0), 1.0) * math.pi) + 1.0) / 2.0
    gate = float(step < 1000)
    out["loss_sdf_large"] = large_loss * anneal * gate
    out["loss_sdf_small"] = small_mean / ((small_mean > 1e-5).float() + 1e-3) * anneal * gate
    if s["apply_occ_loss"]:
        out["loss_occ"] = (occ_loss(P, s, gen, pts_in, reflective, occ_prob[..., 0], sdf,
                                    grads, dirs_in, mode)
                           if step >= s["occ_loss_step"] else rgb.new_zeros(()))
    return out


def lr_at(step: int, cfg: dict) -> float:
    """NeRO's warm_up_cos: linear to lr over end_warm steps, then cosine to 0.05 lr."""
    c = {"end_warm": 5000, "end_iter": cfg.get("total_step", 300000), "lr": 5e-4,
         **(cfg.get("lr_cfg") or {})}
    if step < c["end_warm"]:
        return c["lr"] * step / c["end_warm"]
    progress = min(max((step - c["end_warm"]) / (c["end_iter"] - c["end_warm"]), 0.0), 1.0)
    return c["lr"] * ((math.cos(math.pi * progress) + 1.0) * 0.5 * 0.95 + 0.05)


def tree_items(tree, prefix=""):
    """(path, leaf) in sorted-key order; paths join keys and indices with '|'."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}{k}|")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}{i}|")
    else:
        yield prefix[:-1], tree


def run_steps(cfg: dict, params0: dict, scene: dict, gen_state: torch.Tensor, step0: int,
              n: int, mode: str = "f32", device="cuda") -> dict:
    """n training steps from step0 on one scene. Returns {"losses": [each
    step's terms and "loss_total", floats], "grad_norms": {leaf: |g| of the
    first step}, "change_norms": {leaf: |p_n - p_0|}}."""
    s = settings(cfg)
    P = {k: v for k, v in tree_items(params0)}
    leaves = {k: v.detach().clone().float().requires_grad_(True) for k, v in P.items()}
    tree = _rebuild(params0, leaves)
    lut = fields.fg_lut(device)
    d = scene_tensors(scene, device, s["fixed_camera"])
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    m = {k: torch.zeros_like(v) for k, v in leaves.items()}
    v2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    out = {"losses": [], "grad_norms": {}}
    with exact_float32():
        for i in range(n):
            step = step0 + i
            batch = ray_batch(gen, d, s["train_ray_num"])
            terms = losses(tree, s, lut, batch, step, gen, mode)
            total = sum(terms.values())
            grads = torch.autograd.grad(total, list(leaves.values()), allow_unused=True)
            lr = lr_at(step, cfg)
            with torch.no_grad():
                for (k, p), g in zip(leaves.items(), grads):
                    g = torch.zeros_like(p) if g is None else g
                    if i == 0:
                        out["grad_norms"][k] = float(torch.linalg.norm(g))
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    mh = m[k] / (1 - b1 ** (i + 1))
                    vh = v2[k] / (1 - b2 ** (i + 1))
                    p.sub_(lr * mh / (torch.sqrt(vh) + eps))
            out["losses"].append({**{k: float(v.detach()) for k, v in terms.items()},
                                  "loss_total": float(total.detach())})
    out["change_norms"] = {k: float(torch.linalg.norm(leaves[k].detach() - P[k].detach().float()))
                           for k in leaves}
    return out


def _rebuild(tree, leaves: dict, prefix=""):
    """`tree`'s structure with the leaves of `leaves` by path."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves, f"{prefix}{k}|") for k in tree}
    if isinstance(tree, list):
        return [_rebuild(v, leaves, f"{prefix}{i}|") for i, v in enumerate(tree)]
    return leaves[prefix[:-1]]
