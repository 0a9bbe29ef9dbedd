"""What tests/test_torch_encoding_widths_shader*.py share: the whole-shader
kernel (B2) at IDE degrees 1-4 and light PE octaves 4 and 10, its plain
twin and an emulation of its rounding points against nero_tpu's
`shader_fused_raw` in interpret mode. Imported by its own name, as
torch_shader_common is."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from nero_tpu.fields.app_shading import (AppShadingConfig as JCfg, _app_shading_apply_fused,
                                         app_shading_apply as jax_apply, init_app_shading)
from nero_tpu.ops.fg_lut import get_fg_lut as jax_fg_lut
from nero_tpu.ops.mlp import hidden_dtype
from nero_tpu.ops.pallas.shader_kernel import shader_fused_raw
from nero_tpu_torch.core.convert import from_numpy_tree, tree_items
from nero_tpu_torch.fields.app_shading import AppShadingConfig, app_shading_apply, shade_from_raw
from nero_tpu_torch.ops import shader
from nero_tpu_torch.ops.fg_lut import get_fg_lut
from nero_tpu_torch.ops.mlp import resolve_weight_norm
from torch_shader_common import VARIANTS, _kernel_head

R, S = 2, 24
ENCODINGS = [(d, p) for d in (1, 2, 3, 4) for p in (4, 10)]


def scale_pe_rows(params_j, lpf, rng):
    """The first-layer rows of the light points' PE octave i (its sin and
    cos rows) in the inner light and inner weight heads drawn at 0.01 / 2^i,
    as kernel_variants.py::sdf_params draws the SDF's: past about octave 20
    sin of the f32 argument x 2^i carries no signal in either package (the
    last bits of x decide it), and flat weights would compare that noise."""
    rows = 6 * lpf
    amp = (0.01 / 2.0 ** (np.arange(rows) // 6))[:, None].astype(np.float32)
    for head in ("inner_light", "inner_weight"):
        v = params_j[head][0]["v"].copy()
        v[3:3 + rows] = amp * rng.standard_normal((rows, v.shape[1])).astype(np.float32)
        params_j[head][0]["v"] = v
    return params_j


def setup(variant, deg, lpf, scaled_pe=False):
    """(kw, numpy params, inputs, cotangents) of one variant at (deg, lpf):
    random camera frames (hit and miss rows of the human light), a few
    points outside radius 0.999; `scaled_pe`: the light points' PE rows by
    `scale_pe_rows`."""
    kw = dict(VARIANTS[variant], ide_deg=deg, light_pos_freq=lpf)
    params_j = jax.tree_util.tree_map(
        np.asarray, init_app_shading(jax.random.PRNGKey(10 * deg + lpf), JCfg(**kw)))
    rng = np.random.default_rng(deg * 100 + lpf)
    if scaled_pe:
        params_j = scale_pe_rows(params_j, lpf, np.random.default_rng(lpf))
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    q, _ = np.linalg.qr(rng.standard_normal((R, S, 3, 3)))
    hp = np.concatenate([q, rng.uniform(-0.5, 0.5, (R, S, 3, 1))], -1).astype(np.float32)
    inputs = {"pts": rng.uniform(-0.6, 0.6, (R, S, 3)).astype(np.float32),
              "normals": f(R, S, 3), "view": f(R, S, 3), "feats": f(R, S, 256) * 0.3, "hp": hp}
    inputs["pts"][0, :4] *= 2.5
    return kw, params_j, inputs, (f(R, S, 3), f(R, S, 1))


def check_forward(variant, deg, lpf, scaled_pe=False):
    """The packed raw [.., 24] of the plain twin (the wrapper on the CPU) and
    of the emulated kernel (every head through `_kernel_head`: bf16
    operands, f32 sums) against `shader_fused_raw` in interpret mode, column
    by column: the heads to 3e-2 (plain, f32 against bf16) and 2e-3
    (emulated), reflective and NoV to 1e-5, the human hit mask equal on
    >= 0.9999 of the rows; colour and occ_prob of the emulated raw within
    2e-3 of the plain one's (PERF.md section 6's bar); the packed weights
    at the encodings' pads unpack to every head's shape."""
    kw, params_j, inputs, _ = setup(variant, deg, lpf, scaled_pe)
    cfg = AppShadingConfig(**kw)
    human = cfg.human_light
    args = [jnp.asarray(inputs[k]) for k in ("pts", "normals", "view", "feats")]
    raw_j = {k: np.asarray(v) for k, v in shader_fused_raw(
        params_j, JCfg(**kw), *args, human_poses=jnp.asarray(inputs["hp"]),
        interpret=True).items()}
    p = from_numpy_tree(params_j, requires_grad=False)
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    hp = t["hp"] if human else None
    plain = shader.shader_raw(p, cfg, t["pts"], t["normals"], t["view"], t["feats"], hp)
    emu = shader.shader_raw_plain(resolve_weight_norm(p), cfg, t["pts"], t["normals"], t["view"],
                                  t["feats"], hp, head=_kernel_head)
    for raw, head_tol in ((plain, 3e-2), (emu, 2e-3)):
        got = {k: v.numpy() for k, v in shader.unpack_raw(raw, human).items()}
        assert set(got) == set(raw_j)
        for k, want in raw_j.items():
            if k == "human_hits":
                assert float((got[k] == want).mean()) >= 0.9999
                assert 0.02 < float(want.mean()) < 0.98, "no hit and miss rows: vacuous"
                continue
            tol = 1e-5 if k in ("reflective", "NoV") else head_tol
            np.testing.assert_allclose(got[k], want, atol=tol, rtol=0,
                                       err_msg=f"{variant} {deg} {lpf} {k}")
    lut = torch.from_numpy(get_fg_lut())
    (c_e, o_e), (c_p, o_p) = shade_from_raw(emu, cfg, lut), shade_from_raw(plain, cfg, lut)
    np.testing.assert_allclose(c_e.numpy(), c_p.numpy(), atol=2e-3)
    np.testing.assert_allclose(o_e["occ_prob"].numpy(), o_p["occ_prob"].numpy(), atol=2e-3)
    # the packed layout at these encodings' pads, and back
    geo, feats, spec, ws, bs = shader.kernel_inputs(p, cfg, t["pts"], t["normals"], t["view"],
                                                    t["feats"], hp)
    assert spec[4] == (deg, lpf) and spec[2] == tuple(shader.head_pad(cfg)[h]
                                                      for h in shader.head_order(cfg))
    W, B = shader.pack_weights(ws, bs, spec[2])
    assert W.numel() == shader.weight_elems(spec[2])
    dws, dbs = shader.unpack_grads(W.float(), B, spec[2], spec[3])
    for w, d in zip(ws, dws):
        assert torch.equal(d, w.to(torch.bfloat16).float())
    for b, d in zip(bs, dbs):
        assert torch.equal(d, b)


def check_grads(variant, deg, lpf, scaled_pe=False):
    """tests/test_torch_shader_variants.py's bar for the TPU kernel's
    gradients, at (deg, lpf), with the port's plain version as the f32
    reference: the kernel's (interpret mode) worst mean error under 4x the
    bf16-XLA path's + 2e-3, every leaf that carries a gradient within cosine
    0.98 (the light heads' below degree 5, as ROADMAP's tolerances ask)."""
    kw, params_j, inputs, cots = setup(variant, deg, lpf, scaled_pe)
    lut_j = jnp.asarray(jax_fg_lut())
    names = ("pts", "normals", "view", "feats")

    def jax_grads(kind):
        def loss(q, pts, nrm, view, ft):
            hp = jnp.asarray(inputs["hp"])
            if kind == "fused":
                c, o = _app_shading_apply_fused(q, JCfg(**kw), lut_j, pts, nrm, view, ft, hp,
                                                False, interpret=True)
            else:
                with hidden_dtype(jnp.bfloat16):
                    c, o = jax_apply(q, JCfg(fused_shader=False, **kw), lut_j, pts, nrm, view,
                                     ft, hp)
            return jnp.sum(c * cots[0]) + jnp.sum(o["occ_prob"] * cots[1])
        g = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(params_j, *[jnp.asarray(inputs[k])
                                                               for k in names])
        return ([a for _, a in tree_items(jax.tree_util.tree_map(np.asarray, g[0]))]
                + [np.asarray(a) for a in g[1:]])

    p = from_numpy_tree(params_j)
    t = {k: torch.from_numpy(v).requires_grad_(k != "hp") for k, v in inputs.items()}
    cfg = AppShadingConfig(**kw)
    c, o = app_shading_apply(p, cfg, torch.from_numpy(get_fg_lut()), t["pts"], t["normals"],
                             t["view"], t["feats"], t["hp"])
    loss = (c * torch.from_numpy(cots[0])).sum() + (o["occ_prob"] * torch.from_numpy(cots[1])).sum()
    leaves = [v for _, v in tree_items(p)] + [t[k] for k in names]
    g32 = [g.numpy() for g in torch.autograd.grad(loss, leaves)]
    gk, gbf = jax_grads("fused"), jax_grads("bf16")

    def worst_mean_rel(ga, gb):
        return max(float((np.abs(a - b) / (np.abs(a).max() + 1e-8)).mean()) for a, b in zip(ga, gb))

    assert worst_mean_rel(g32, gk) < 4.0 * worst_mean_rel(g32, gbf) + 2e-3
    for a, b in zip(g32, gk):
        a, b = a.ravel(), b.ravel()
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        if denom >= 1e-12:
            assert a @ b / denom > 0.98
