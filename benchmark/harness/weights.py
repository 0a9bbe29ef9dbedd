"""The parameters of one Stage-I scene, made on the device from a seed.

The tree has the program's layout (nero_tpu_torch's `init_shape_params`:
{v, g, b} weight-norm layers, {w, b} in the background) and NeRO's
initial distributions: the SDF's geometric init (a sphere of radius 0.5),
PyTorch's default uniform init elsewhere, the heads' final biases. All the
random numbers come from one generator on the device in two calls, one
normal and one uniform, cut into the leaves.
"""
from __future__ import annotations

import math

import torch

from benchmark.reference.encodings import ide_dim, pe_dim


def sdf_shapes(multires: int = 6) -> list:
    """(in, out) of the 8 x 256 SDF's nine layers; the encoding re-enters
    before layer 4, so layer 3 gives 256 minus its width."""
    d0 = pe_dim(3, multires)
    dims = [d0] + [256] * 8 + [257]
    return [(dims[l], dims[l + 1] - d0 if l + 1 == 4 else dims[l + 1])
            for l in range(len(dims) - 1)]


def bg_shapes() -> dict:
    pts, view = pe_dim(4, 10), pe_dim(3, 4)
    return {"pts": [(pts, 256)] + [(256 + pts if i == 4 else 256, 256) for i in range(7)],
            "views": (view + 256, 128), "feature": (256, 256), "alpha": (256, 1),
            "rgb": (128, 3)}


def head_shapes(shader: dict) -> dict:
    """{head: (d_in, d_out, final bias or None)} of the split-sum shader."""
    sph = ide_dim(shader.get("ide_deg", 5))
    pos = pe_dim(3, shader.get("light_pos_freq", 8))
    heads = {"metallic": (259, 1, shader.get("metallic_init", 0.0) or None),
             "roughness": (259, 1, shader.get("roughness_init", 0.0) or None),
             "albedo": (259, 3, None),
             "outer_light": (sph, 3, math.log(0.5)),
             "inner_light": (pos + sph, 3, math.log(0.5)),
             "inner_weight": (pos + pe_dim(3, 6), 1, shader.get("inner_init", -0.95))}
    if shader.get("human_light", False):
        heads["human_light"] = (24, 4, math.log(0.01))
    return heads


def make_params(cfg: dict, seed: int, device) -> dict:
    """One scene's parameter tree (leaves float32, requiring grad)."""
    shader = dict(cfg.get("shader_config") or {})
    sdf = sdf_shapes(cfg.get("sdf_freq", 6))
    bg = bg_shapes()
    heads = head_shapes(shader)
    uniform_shapes = (list(bg["pts"]) + [bg[k] for k in ("views", "feature", "alpha", "rgb")]
                      + [s for d_in, d_out, _ in heads.values()
                         for s in ((d_in, 256), (256, 256), (256, 256), (256, d_out))])
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(sum(i * o for i, o in sdf), generator=gen, device=device)
    uniform = torch.rand(sum(i * o + o for i, o in uniform_shapes), generator=gen,
                         device=device) * 2.0 - 1.0
    cut = {"n": 0, "u": 0}

    def take(buf, n):
        out = (normal if buf == "n" else uniform)[cut[buf]:cut[buf] + n]
        cut[buf] += n
        return out

    def leaf(t):
        return t.contiguous().requires_grad_(True)

    def norm_layer(w, b):
        return {"v": leaf(w), "g": leaf(torch.linalg.norm(w, dim=0, keepdim=True)), "b": leaf(b)}

    def default_dense(d_in, d_out, weight_norm):
        bound = 1.0 / math.sqrt(d_in)
        w = take("u", d_in * d_out).reshape(d_in, d_out) * bound
        b = take("u", d_out) * bound
        return norm_layer(w, b) if weight_norm else {"w": leaf(w), "b": leaf(b)}

    d_in0 = 3
    sdf_layers = []
    for l, (i, o) in enumerate(sdf):
        z = take("n", i * o).reshape(i, o)
        if l == len(sdf) - 1:
            w = math.sqrt(math.pi) / math.sqrt(i) + 1e-4 * z
            b = torch.full((o,), -float(cfg.get("sdf_bias", 0.5)), device=device)
        else:
            w = z * (math.sqrt(2.0) / math.sqrt(o))
            if l == 0:
                w[d_in0:, :] = 0.0
            elif l == 4:
                w[-(sdf[0][0] - d_in0):, :] = 0.0
            b = torch.zeros(o, device=device)
        sdf_layers.append(norm_layer(w, b))
    bg_p = {"pts": [default_dense(i, o, False) for i, o in bg["pts"]]}
    for k in ("views", "feature", "alpha", "rgb"):
        bg_p[k] = default_dense(*bg[k], False)
    with torch.no_grad():
        bg_p["rgb"]["b"].fill_(math.log(0.5))
    shader_p = {}
    for name, (d_in, d_out, final) in heads.items():
        layers = [default_dense(di, do, True)
                  for di, do in ((d_in, 256), (256, 256), (256, 256), (256, d_out))]
        if final is not None:
            with torch.no_grad():
                layers[-1]["b"].fill_(final)
        shader_p[name] = layers
    variance = {"variance": torch.tensor(float(cfg.get("inv_s_init", 0.3)), device=device,
                                         requires_grad=True)}
    return {"sdf": sdf_layers, "variance": variance, "bg": bg_p, "shader": shader_p}
