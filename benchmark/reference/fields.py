"""The fields of NeRO's Stage I, plain torch: the 8 x 256 NeuS SDF with its
spatial gradient, the NeRF++ background and the split-sum shader's heads.

Every dense product goes through `matmul`, which multiplies in float32 (the
reference) or, for the control, on float8 e4m3 operands with a per-tensor
scale and float32 accumulation, in the forward and in every backward
product (so the SDF's gradient differentiates again in either mode).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.encodings import (integrated_dir_encode, integrated_pos_encode,
                                           positional_encode)

E4M3_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to the format's largest value."""
    scale = torch.clamp(t.detach().abs().amax(), min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class _Fp8Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _fp8(x) @ _fp8(w)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx = fp8_product(gy, w.t()) if ctx.needs_input_grad[0] else None
        gw = fp8_product(x.t(), gy) if ctx.needs_input_grad[1] else None
        return gx, gw


def fp8_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _Fp8Product.apply(x, w)


def matmul(x: torch.Tensor, w: torch.Tensor, mode: str = "f32") -> torch.Tensor:
    """x [..., in] @ w [in, out] in `mode` ("f32" or "fp8")."""
    if mode == "f32":
        return x @ w
    if mode == "fp8":
        return fp8_product(x.reshape(-1, x.shape[-1]), w).reshape(*x.shape[:-1], w.shape[1])
    raise ValueError(f"product mode {mode!r}")


def resolve(layer: dict) -> dict:
    """{v, g, b} -> {w = g v / |v| (norm over the fan-in), b}; {w, b} as is."""
    if "v" not in layer:
        return layer
    v = layer["v"]
    return {"w": layer["g"] * v / torch.clamp(torch.linalg.norm(v, dim=0, keepdim=True),
                                              min=1e-12), "b": layer["b"]}


def resolve_tree(tree):
    if isinstance(tree, dict):
        return resolve(tree) if "v" in tree else {k: resolve_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [resolve_tree(v) for v in tree]
    return tree


def dense(layer: dict, x: torch.Tensor, mode: str) -> torch.Tensor:
    return matmul(x, layer["w"], mode) + layer["b"]


# ---------------------------------------------------------------------------
# SDF
# ---------------------------------------------------------------------------

def sdf_apply(layers: list, x: torch.Tensor, multires: int, mode: str,
              skip: int = 4, beta: float = 100.0) -> torch.Tensor:
    """[..., 3] -> [..., 257]: the sdf, then 256 features. Softplus(beta 100)
    between layers, the encoded input concatenated again before layer
    `skip` and the sum divided by sqrt(2)."""
    inputs = positional_encode(x, multires)
    h = inputs
    for l, layer in enumerate(layers):
        if l == skip:
            h = torch.cat([h, inputs], dim=-1) / math.sqrt(2.0)
        h = dense(layer, h, mode)
        if l < len(layers) - 1:
            h = F.softplus(h, beta=beta)
    return h


def sdf_value(layers, x, multires: int, mode: str) -> torch.Tensor:
    return sdf_apply(layers, x, multires, mode)[..., :1]


def sdf_with_grad(layers, x: torch.Tensor, multires: int, mode: str):
    """(sdf [..., 1], features [..., 256], d sdf / dx [..., 3]); the gradient
    by reverse mode, differentiable again when grad mode is on."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        out = sdf_apply(layers, xg, multires, mode)
        (grad,) = torch.autograd.grad(out[..., 0].sum(), xg, create_graph=create)
    if not create:
        out = out.detach()
    return out[..., :1], out[..., 1:], grad


# ---------------------------------------------------------------------------
# NeRF++ background
# ---------------------------------------------------------------------------

def bg_nerf_apply(p: dict, pts4: torch.Tensor, view_dirs: torch.Tensor, mode: str):
    """(x/|x|, 1/|x|) with PE 10 and the view with PE 4 -> (density, raw rgb)."""
    input_pts = positional_encode(pts4, 10)
    input_views = positional_encode(view_dirs, 4)
    h = input_pts
    for i, layer in enumerate(p["pts"]):
        h = torch.relu(dense(layer, h, mode))
        if i == 4:
            h = torch.cat([input_pts, h], dim=-1)
    alpha = dense(p["alpha"], h, mode)
    feature = dense(p["feature"], h, mode)
    hv = torch.relu(dense(p["views"], torch.cat([feature, input_views], dim=-1), mode))
    return alpha, dense(p["rgb"], hv, mode)


# ---------------------------------------------------------------------------
# the split-sum shader
# ---------------------------------------------------------------------------

def head(layers: list, x: torch.Tensor, mode: str) -> torch.Tensor:
    """Linear ReLU Linear ReLU Linear ReLU Linear, no final activation."""
    h = x
    for layer in layers[:-1]:
        h = torch.relu(dense(layer, h, mode))
    return dense(layers[-1], h, mode)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    eps = float(torch.finfo(torch.float32).eps)
    return torch.where(x <= 0.0031308, 323.0 / 25.0 * x,
                       (211.0 * torch.clamp(x, min=eps) ** (5.0 / 12.0) - 11.0) / 200.0)


def fg_lut(device, res: int = 256, n_samples: int = 1024) -> torch.Tensor:
    """The split-sum environment BRDF table [roughness, NoV, (A, B)]: GGX
    importance sampling over a Hammersley set, float64, then float32."""
    i = torch.arange(n_samples, dtype=torch.int64)
    bits = torch.zeros_like(i)
    for b in range(32):
        bits |= ((i >> b) & 1) << (31 - b)
    x1 = (i.double() / n_samples).to(device)
    x2 = (bits.double() * 2.3283064365386963e-10).to(device)
    f64 = dict(dtype=torch.float64, device=device)
    nov = torch.clamp((torch.arange(res, **f64) + 0.5) / res, 1e-4, 1.0)[None, :, None]
    a = (((torch.arange(res, **f64) + 0.5) / res) ** 2)[:, None, None]
    k = a / 2.0
    vx, vz = torch.sqrt(1.0 - nov ** 2), nov
    A = torch.zeros(res, res, **f64)
    B = torch.zeros(res, res, **f64)
    for c in range(0, n_samples, 64):
        phi = 2.0 * math.pi * x1[c:c + 64]
        u = x2[c:c + 64]
        cos_t = torch.sqrt((1.0 - u) / (1.0 + (a ** 2 - 1.0) * u))
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t ** 2, min=0.0))
        hx, hz = torch.cos(phi) * sin_t, cos_t
        voh = vx * hx + vz * hz
        nol = 2.0 * voh * hz - vz
        valid = nol > 0
        voh_c = torch.clamp(voh, 0.0, 1.0)
        nol_c = torch.clamp(nol, 1e-6, 1.0)
        noh_c = torch.clamp(hz.expand_as(voh), 1e-6, 1.0)
        g = (nol_c / (nol_c * (1 - k) + k)) * (nov / (nov * (1 - k) + k))
        g_vis = g * voh_c / (noh_c * nov)
        fc = (1.0 - voh_c) ** 5
        A += torch.where(valid, (1.0 - fc) * g_vis, 0.0).sum(-1)
        B += torch.where(valid, fc * g_vis, 0.0).sum(-1)
    return (torch.stack([A, B], -1) / n_samples).float()


def fg_lookup(lut: torch.Tensor, nov: torch.Tensor, roughness: torch.Tensor) -> torch.Tensor:
    """Clamped bilinear sample with texel centres at (i + 0.5) / res."""
    res = lut.shape[0]
    u = torch.clamp(nov[..., 0], 0.0, 1.0) * res - 0.5
    v = torch.clamp(roughness[..., 0], 0.0, 1.0) * res - 0.5
    u0 = torch.clamp(torch.floor(u), 0, res - 1)
    v0 = torch.clamp(torch.floor(v), 0, res - 1)
    u1 = torch.clamp(u0 + 1, 0, res - 1)
    v1 = torch.clamp(v0 + 1, 0, res - 1)
    fu = torch.clamp(u - u0, 0.0, 1.0)[..., None]
    fv = torch.clamp(v - v0, 0.0, 1.0)[..., None]
    u0, u1, v0, v1 = u0.long(), u1.long(), v0.long(), v1.long()
    top = lut[v0, u0] * (1 - fu) + lut[v0, u1] * fu
    bot = lut[v1, u0] * (1 - fu) + lut[v1, u1] * fu
    return top * (1 - fv) + bot * fv


def human_light_input(points, reflective, human_poses, roughness):
    """(IPE of where the reflected ray meets the camera plane, hit mask)."""
    R, t = human_poses[..., :, :3], human_poses[..., :, 3]
    pts_h = torch.einsum("...ij,...j->...i", R, points) + t
    dirs_h = torch.einsum("...ij,...j->...i", R, reflective)
    hits = torch.abs(dirs_h[..., 2:3]) > 1e-4
    dirs_z = torch.where(hits, dirs_h[..., 2:3], torch.full_like(dirs_h[..., 2:3], 1e-4))
    dist = -pts_h[..., 2:3] / dirs_z
    mean = (pts_h[..., :2] + dist * dirs_h[..., :2]) * 0.3
    var = roughness * (dist * 0.3) ** 2
    hits = hits & (torch.linalg.norm(mean, dim=-1, keepdim=True) < 1.5) & (dist > 0)
    hitsf = hits.to(mean.dtype)
    mean = mean * hitsf
    var = (var * hitsf).expand(mean.shape)
    return integrated_pos_encode(mean, var, 0, 6), hitsf


def shade(p: dict, sc: dict, lut, points, normals, view_dirs, feats, human_poses, mode: str):
    """(colour in sRGB [..., 3], reflected direction [..., 3], occlusion
    probability [..., 1]) of NeRO's split-sum shader at surface samples."""
    if sc.get("sphere_direction", False):
        raise NotImplementedError("sphere_direction is not a configuration of this benchmark")
    deg, lpf = sc.get("ide_deg", 5), sc.get("light_pos_freq", 8)
    normals, view_dirs = _normalize(normals), _normalize(view_dirs)
    nov = torch.sum(view_dirs * normals, -1, keepdim=True)
    reflective = nov * normals * 2 - view_dirs
    x_mat = torch.cat([feats, points], -1)
    metallic = torch.sigmoid(head(p["metallic"], x_mat, mode))
    roughness = torch.sigmoid(head(p["roughness"], x_mat, mode))
    albedo = torch.sigmoid(head(p["albedo"], x_mat, mode))
    ide_n = integrated_dir_encode(normals, torch.ones_like(points[..., :1]), deg)
    ide_r = integrated_dir_encode(reflective, roughness, deg)
    exp_max = sc.get("light_exp_max", 0.0)
    light = lambda z: torch.exp(torch.clamp(z, max=exp_max))
    diffuse_light = light(head(p["outer_light"], ide_n, mode))
    direct_light = light(head(p["outer_light"], ide_r, mode))
    pe_pts = positional_encode(points, lpf)
    indirect = light(head(p["inner_light"], torch.cat([pe_pts, ide_r], -1), mode))
    occ_in = torch.cat([pe_pts, positional_encode(reflective, 6)], -1).detach()
    occ_prob = head(p["inner_weight"], occ_in, mode) * 0.5 + 0.5
    occ_c = torch.clamp(occ_prob, 0.0, 1.0)
    if sc.get("human_light", False):
        ipe, hitsf = human_light_input(points, reflective, human_poses, roughness)
        human = torch.exp(torch.clamp(head(p["human_light"], ipe, mode), max=0.0)) * hitsf.detach()
        weight = torch.clamp(human[..., 3:], 0.0, 1.0)
        direct_light = human[..., :3] * weight + direct_light * (1 - weight)
    specular_light = indirect * occ_c + direct_light * (1 - occ_c)
    diffuse = (1 - metallic) * albedo * diffuse_light
    specular_albedo = 0.04 * (1 - metallic) + metallic * albedo
    fg = fg_lookup(lut, torch.clamp(nov, 0.0, 1.0), torch.clamp(roughness, 0.0, 1.0))
    specular = (specular_albedo * fg[..., 0:1] + fg[..., 1:2]) * specular_light
    color = torch.clamp(linear_to_srgb(diffuse + specular), 0.0, 1.0)
    return color, reflective, occ_prob
