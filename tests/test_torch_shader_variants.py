"""The `sphere_direction` and `human_light` variants of the Stage-I shader:
the port's whole-shader path (`ops/shader.py::shader_raw_plain` through
`app_shading_apply`; the CUDA kernel runs on the card only) and its per-head
path (`fused_shader: false`, with and without `fused_heads`) against
nero_tpu's XLA shader in f32, and against the TPU kernel
`shader_fused_raw` in interpret mode at the bars of
tests/test_shader_kernel.py. Values, intermediates and gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nero_tpu.fields.app_shading import (AppShadingConfig as JCfg, _app_shading_apply_fused,
                                         app_shading_apply as jax_apply, init_app_shading)
from nero_tpu.ops.fg_lut import get_fg_lut as jax_fg_lut
from nero_tpu.ops.mlp import hidden_dtype
from nero_tpu.ops.pallas.shader_kernel import shader_fused_raw
from nero_tpu_torch.core.convert import from_numpy_tree, tree_items
from nero_tpu_torch.fields.app_shading import (AppShadingConfig, app_shading_apply,
                                               fused_shader_active, heads_raw)
from nero_tpu_torch.ops import shader
from nero_tpu_torch.ops.fg_lut import get_fg_lut

torch.set_num_threads(1)

R, S = 2, 48
VARIANTS = {"sphere": dict(sphere_direction=True), "human": dict(human_light=True),
            "both": dict(sphere_direction=True, human_light=True)}
# the port's shader paths: whole-shader function, per-head, per-head through
# the predictor function
PATHS = {"whole": dict(), "heads": dict(fused_shader=False),
         "heads_fused": dict(fused_shader=False, fused_heads=True)}


def _setup(variant):
    """tests/test_shader_kernel.py::_human_setup's regime: random rotations
    and small translations, so the camera plane has hit and miss rows."""
    kw = VARIANTS[variant]
    params_j = jax.tree_util.tree_map(
        np.asarray, init_app_shading(jax.random.PRNGKey(0), JCfg(**kw)))
    rng = np.random.default_rng(11)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    q, _ = np.linalg.qr(rng.standard_normal((R, S, 3, 3)))
    hp = np.concatenate([q, rng.uniform(-0.5, 0.5, (R, S, 3, 1))], -1).astype(np.float32)
    inputs = {"pts": rng.uniform(-0.6, 0.6, (R, S, 3)).astype(np.float32),
              "normals": f(R, S, 3), "view": f(R, S, 3), "feats": f(R, S, 256) * 0.3, "hp": hp}
    # a few points outside radius 0.999: the sphere variant rescales them
    inputs["pts"][0, :4] *= 2.5
    return kw, params_j, inputs, (f(R, S, 3), f(R, S, 1))


@pytest.fixture(scope="module", params=list(VARIANTS))
def setup(request):
    return (request.param,) + _setup(request.param)


def _jax_fn(kind, kw):
    lut = jnp.asarray(jax_fg_lut())

    def f(p, pts, nrm, view, feats, hp, inter=False):
        if kind == "fused":
            return _app_shading_apply_fused(p, JCfg(**kw), lut, pts, nrm, view, feats, hp, inter,
                                            interpret=True)
        cfg = JCfg(fused_shader=False, **kw)
        if kind == "bf16":
            with hidden_dtype(jnp.bfloat16):
                return jax_apply(p, cfg, lut, pts, nrm, view, feats, hp, inter_results=inter)
        return jax_apply(p, cfg, lut, pts, nrm, view, feats, hp, inter_results=inter)
    return f


def _jax_grads(kind, kw, params_j, inputs, cots):
    fn = _jax_fn(kind, kw)

    def loss(p, pts, nrm, view, ft):
        c, o = fn(p, pts, nrm, view, ft, jnp.asarray(inputs["hp"]))
        return jnp.sum(c * cots[0]) + jnp.sum(o["occ_prob"] * cots[1])
    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        params_j, *[jnp.asarray(inputs[k]) for k in ("pts", "normals", "view", "feats")])
    gp = jax.tree_util.tree_map(np.asarray, g[0])
    return [(k, a) for k, a in tree_items(gp)] + [(n, np.asarray(a)) for n, a in
                                                  zip(("pts", "normals", "view", "feats"), g[1:])]


def _port(kw, path, params_j, inputs, inter=False):
    p = from_numpy_tree(params_j)
    t = {k: torch.from_numpy(v).requires_grad_(k != "hp") for k, v in inputs.items()}
    cfg = AppShadingConfig(**kw, **PATHS[path])
    out = app_shading_apply(p, cfg, torch.from_numpy(get_fg_lut()), t["pts"], t["normals"],
                            t["view"], t["feats"], t["hp"], inter_results=inter)
    return p, t, out


def _port_grads(kw, path, params_j, inputs, cots):
    p, t, (c, o) = _port(kw, path, params_j, inputs)
    loss = (c * torch.from_numpy(cots[0])).sum() + (o["occ_prob"] * torch.from_numpy(cots[1])).sum()
    leaves = [v for _, v in tree_items(p)] + [t[k] for k in ("pts", "normals", "view", "feats")]
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


@pytest.mark.parametrize("path", list(PATHS))
def test_forward_matches_xla_f32(setup, path):
    """Colour, occ_prob, reflective and every intermediate panel (the
    `human_light` panel too) to 2e-5: f32 on both sides."""
    variant, kw, params_j, inputs, _ = setup
    c_j, o_j, inter_j = _jax_fn("xla", kw)(params_j, *[jnp.asarray(inputs[k]) for k in
                                                        ("pts", "normals", "view", "feats", "hp")],
                                          inter=True)
    with torch.no_grad():
        _, _, (c_t, o_t, inter_t) = _port(kw, path, params_j, inputs, inter=True)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=2e-5)
    np.testing.assert_allclose(o_t["occ_prob"].numpy(), np.asarray(o_j["occ_prob"]), atol=2e-5)
    np.testing.assert_allclose(o_t["reflective"].numpy(), np.asarray(o_j["reflective"]),
                               atol=1e-5)
    assert set(inter_t) == set(inter_j)
    assert ("human_light" in inter_t) == bool(kw.get("human_light"))
    for k in inter_j:
        np.testing.assert_allclose(inter_t[k].numpy(), np.asarray(inter_j[k]), atol=2e-5,
                                   err_msg=k)
    if kw.get("human_light"):
        # the human head must contribute (hit rows exist), else this is vacuous
        assert float(np.abs(inter_t["human_light"].numpy()).max()) > 1e-4


def test_forward_vs_tpu_kernel_at_its_bar(setup):
    """test_forward_parity[sphere] / test_human_light_forward_parity: 2e-3 on
    colour and occ_prob, 5e-3 on the human panel (bf16 operands there)."""
    variant, kw, params_j, inputs, _ = setup
    args = [jnp.asarray(inputs[k]) for k in ("pts", "normals", "view", "feats", "hp")]
    c_k, o_k, inter_k = _jax_fn("fused", kw)(params_j, *args, inter=True)
    with torch.no_grad():
        _, _, (c_t, o_t, inter_t) = _port(kw, "whole", params_j, inputs, inter=True)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_k), atol=2e-3)
    np.testing.assert_allclose(o_t["occ_prob"].numpy(), np.asarray(o_k["occ_prob"]), atol=2e-3)
    if kw.get("human_light"):
        np.testing.assert_allclose(inter_t["human_light"].numpy(),
                                   np.asarray(inter_k["human_light"]), atol=5e-3)


def test_packed_layout_matches_tpu_kernel(setup):
    """The packed raw tensor column by column against `shader_fused_raw`
    (interpret): heads to 3e-2 (bf16), geometry columns to 1e-5, the hit
    mask equal, columns 19:24 zero without the human light."""
    variant, kw, params_j, inputs, _ = setup
    raw_j = shader_fused_raw(params_j, JCfg(**kw), *[jnp.asarray(inputs[k]) for k in
                                                     ("pts", "normals", "view", "feats")],
                             human_poses=jnp.asarray(inputs["hp"]), interpret=True)
    cfg = AppShadingConfig(**kw)
    p = from_numpy_tree(params_j)
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    with torch.no_grad():
        whole = shader.shader_raw(p, cfg, t["pts"], t["normals"], t["view"], t["feats"], t["hp"])
        heads = heads_raw(p, cfg, t["pts"], t["normals"], t["view"], t["feats"], t["hp"])
    assert whole.shape == (R, S, shader.OUT)
    torch.testing.assert_close(whole, heads, atol=1e-5, rtol=1e-5)
    raw_t = shader.unpack_raw(whole, cfg.human_light)
    assert set(raw_t) == set(raw_j)
    for k, v in raw_j.items():
        tol = 1e-5 if k in ("reflective", "NoV") else 0 if k == "human_hits" else 3e-2
        np.testing.assert_allclose(raw_t[k].numpy(), np.asarray(v), atol=tol, err_msg=k)
    if not cfg.human_light:
        assert torch.all(whole[..., 19:] == 0)
    else:
        assert 0.05 < float(raw_t["human_hits"].mean()) < 0.95


@pytest.mark.parametrize("path", list(PATHS))
def test_grads_match_xla_f32(setup, path):
    """Every param leaf (the human head's too), points, normals, view and
    feats: normalised max error < 2e-4 (f32; leaves below 1e-3 of the
    largest gradient are held to that floor)."""
    variant, kw, params_j, inputs, cots = setup
    g_j = _jax_grads("xla", kw, params_j, inputs, cots)
    g_t = _port_grads(kw, path, params_j, inputs, cots)
    floor = 1e-3 * max(np.abs(a).max() for _, a in g_j)
    for (k, a), b in zip(g_j, g_t):
        scale = max(np.abs(a).max(), floor)
        np.testing.assert_allclose(b / scale, a / scale, atol=2e-4, err_msg=k)
    if kw.get("human_light"):
        hnorm = sum(np.linalg.norm(b) for (k, _), b in zip(g_j, g_t) if k.startswith("human"))
        assert hnorm > 1e-6, "the human head got no gradient: the test is vacuous"


def test_grads_vs_tpu_kernel_at_its_bar(setup):
    """test_human_light_grad_parity's bar with the port's plain version as the
    f32 reference: the bf16 kernel's worst mean error under 4x the bf16-XLA
    path's + 2e-3, and every leaf that carries a gradient within cosine 0.98."""
    variant, kw, params_j, inputs, cots = setup
    g32 = _port_grads(kw, "whole", params_j, inputs, cots)
    gbf = [a for _, a in _jax_grads("bf16", kw, params_j, inputs, cots)]
    gk = [a for _, a in _jax_grads("fused", kw, params_j, inputs, cots)]

    def worst_mean_rel(ga, gb):
        return max(float((np.abs(a - b) / (np.abs(a).max() + 1e-8)).mean()) for a, b in zip(ga, gb))

    assert worst_mean_rel(g32, gk) < 4.0 * worst_mean_rel(g32, gbf) + 2e-3
    for a, b in zip(g32, gk):
        a, b = a.ravel(), b.ravel()
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        if denom >= 1e-12:
            assert a @ b / denom > 0.98


def test_human_mixing():
    """direct = human_light * w + direct * (1 - w) with w = clip(exp(min(z, 0))
    * hit, 0, 1): where the mask is 0 the colour equals the variant without
    the human head, where it is 1 it differs."""
    kw, params_j, inputs, _ = _setup("human")
    with torch.no_grad():
        _, _, (c_h, _, inter) = _port(kw, "whole", params_j, inputs, inter=True)
        p = from_numpy_tree({k: v for k, v in params_j.items() if k != "human_light"})
        t = {k: torch.from_numpy(v) for k, v in inputs.items()}
        c_0, _ = app_shading_apply(p, AppShadingConfig(), torch.from_numpy(get_fg_lut()),
                                   t["pts"], t["normals"], t["view"], t["feats"])
        raw = shader.unpack_raw(shader.shader_raw(from_numpy_tree(params_j),
                                                  AppShadingConfig(**kw), t["pts"], t["normals"],
                                                  t["view"], t["feats"], t["hp"]), True)
    miss = raw["human_hits"][..., 0] == 0
    assert miss.any() and (~miss).any()
    torch.testing.assert_close(c_h[miss], c_0[miss], atol=1e-6, rtol=0)
    assert torch.all(inter["human_light"][miss] == 0)
    assert (c_h[~miss] - c_0[~miss]).abs().max() > 1e-5


def test_routing_and_errors():
    assert fused_shader_active(AppShadingConfig()) and fused_shader_active(
        AppShadingConfig(human_light=True))
    assert fused_shader_active(AppShadingConfig(fused_shader=True))
    assert not fused_shader_active(AppShadingConfig(fused_shader=False))
    cfg = AppShadingConfig(human_light=True)
    z3, z256 = torch.zeros(1, 3), torch.zeros(1, 256)
    with pytest.raises(ValueError, match="human_poses"):
        app_shading_apply({}, cfg, None, z3, z3, z3, z256)
    with pytest.raises(ValueError, match="human_poses"):
        shader.shader_raw({}, cfg, z3, z3, z3, z256)


def test_kernel_layout_bookkeeping():
    """Head order, padded widths, geometry width, packed weight count and
    launch counters of every variant (what csrc/shader.cu's Var<> derives)."""
    for kw, sfx, geo, outer in ((dict(), "", 9, 80), (VARIANTS["sphere"], "_sphere", 9, 144),
                                (VARIANTS["human"], "_human", 21, 80),
                                (VARIANTS["both"], "_sphere_human", 21, 144)):
        cfg = AppShadingConfig(**kw)
        assert shader.supported(cfg) and shader.variant(cfg) == sfx
        assert shader.geo_width(cfg) == geo
        heads, pads = shader.head_order(cfg), shader.head_pad(cfg)
        assert len(heads) == (7 if cfg.human_light else 6)
        assert pads["outer_light"] == outer and pads["metallic"] == 272
        assert f"shader_fwd{sfx}" in shader.launches and f"shader_bwd{sfx}" in shader.launches
        n_w = shader.weight_elems([pads[h] for h in heads])
        expect = sum(pads[h] * 256 + 2 * 256 * 256 + 256 * 16 for h in heads)
        assert n_w == expect
        if cfg.human_light:
            assert pads["human_light"] == 32 and shader.head_dims(cfg)["human_light"] == (24, 4)
        assert shader.flops(10, cfg, True) == 3 * shader.flops(10, cfg)
    assert not shader.supported(AppShadingConfig(feats_dim=128))


def test_pack_unpack_round_trip():
    kw, params_j, _, _ = _setup("both")
    cfg = AppShadingConfig(**kw)
    from nero_tpu_torch.ops.mlp import resolve_weight_norm
    layers = resolve_weight_norm(from_numpy_tree(params_j))
    heads = shader.head_order(cfg)
    ws = [l["w"].detach() for h in heads for l in layers[h]]
    bs = [l["b"].detach() for h in heads for l in layers[h]]
    pads = [shader.head_pad(cfg)[h] for h in heads]
    dims = [shader.head_dims(cfg)[h] for h in heads]
    W, B = shader.pack_weights(ws, bs, pads)
    assert B.shape == (7, 4, 256) and W.numel() == shader.weight_elems(pads)
    dws, dbs = shader.unpack_grads(W.float(), B, pads, dims)
    for w, dw, b, db in zip(ws, dws, bs, dbs):
        torch.testing.assert_close(dw, w.to(torch.bfloat16).float(), atol=0, rtol=0)
        torch.testing.assert_close(db, b, atol=0, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cuda_kernel_matches_plain_version(variant):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    kw, params_j, inputs, _ = _setup(variant)
    dev = torch.device("cuda")
    p = from_numpy_tree(params_j, device=dev)
    t = [torch.from_numpy(inputs[k]).to(dev) for k in ("pts", "normals", "view", "feats", "hp")]
    cfg = AppShadingConfig(**kw)
    with torch.no_grad():
        k = shader.shader_raw(p, cfg, *t)
        ref = shader.shader_raw_plain(p, cfg, *t)
    torch.testing.assert_close(k[..., 15:19], ref[..., 15:19], atol=1e-5, rtol=0)
    torch.testing.assert_close(k, ref, atol=3e-2, rtol=3e-2)
