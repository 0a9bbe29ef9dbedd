"""The default-variant shader: the port's plain version (CPU side of
ops/shader.py, through fields/app_shading.py) against nero_tpu's XLA shader
in f32, and against the TPU kernel path `_app_shading_apply_fused` in
interpret mode at the bars of tests/test_shader_kernel.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nero_tpu.fields.app_shading import (AppShadingConfig as JCfg, _app_shading_apply_fused,
                                         app_shading_apply as jax_apply, init_app_shading)
from nero_tpu.ops.fg_lut import get_fg_lut as jax_fg_lut
from nero_tpu.ops.mlp import hidden_dtype
from nero_tpu_torch.core.convert import from_numpy_tree, tree_items
from nero_tpu_torch.fields.app_shading import AppShadingConfig, app_shading_apply
from nero_tpu_torch.ops import shader
from nero_tpu_torch.ops.fg_lut import get_fg_lut

R, S = 2, 64


@pytest.fixture(scope="module")
def setup():
    params_j = jax.tree_util.tree_map(np.asarray, init_app_shading(jax.random.PRNGKey(0), JCfg()))
    rng = np.random.default_rng(1)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    inputs = {"pts": rng.uniform(-0.6, 0.6, (R, S, 3)).astype(np.float32),
              "normals": f(R, S, 3), "view": f(R, S, 3), "feats": f(R, S, 256) * 0.3}
    cots = (f(R, S, 3), f(R, S, 1))
    return params_j, inputs, cots


def _jax_fn(kind):
    cfg = JCfg(fused_shader=False)
    lut = jnp.asarray(jax_fg_lut())
    hp = jnp.zeros((R, S, 3, 4))

    def f(p, pts, nrm, view, feats, inter=False):
        if kind == "fused":
            return _app_shading_apply_fused(p, JCfg(), lut, pts, nrm, view, feats, hp, inter,
                                            interpret=True)
        if kind == "bf16":
            with hidden_dtype(jnp.bfloat16):
                return jax_apply(p, cfg, lut, pts, nrm, view, feats, hp, inter_results=inter)
        return jax_apply(p, cfg, lut, pts, nrm, view, feats, hp, inter_results=inter)
    return f


def _jax_grads(kind, params_j, inputs, cots):
    fn = _jax_fn(kind)

    def loss(p, nrm, ft):
        c, o = fn(p, jnp.asarray(inputs["pts"]), nrm, jnp.asarray(inputs["view"]), ft)
        return jnp.sum(c * cots[0]) + jnp.sum(o["occ_prob"] * cots[1])
    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        params_j, jnp.asarray(inputs["normals"]), jnp.asarray(inputs["feats"]))
    gp = jax.tree_util.tree_map(np.asarray, g[0])
    return [a for _, a in tree_items(gp)] + [np.asarray(g[1]), np.asarray(g[2])]


def _port(params_j, inputs, inter=False):
    p = from_numpy_tree(params_j)
    t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in inputs.items()}
    out = app_shading_apply(p, AppShadingConfig(), torch.from_numpy(get_fg_lut()), t["pts"],
                            t["normals"], t["view"], t["feats"], inter_results=inter)
    return p, t, out


def _port_grads(params_j, inputs, cots):
    p, t, (c, o) = _port(params_j, inputs)
    loss = (c * torch.from_numpy(cots[0])).sum() + (o["occ_prob"] * torch.from_numpy(cots[1])).sum()
    leaves = [v for _, v in tree_items(p)] + [t["normals"], t["feats"]]
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


@pytest.mark.parametrize("reference,atol", [("xla", 1e-5), ("fused", 2e-3)])
def test_forward(setup, reference, atol):
    params_j, inputs, _ = setup
    c_j, o_j, inter_j = _jax_fn(reference)(params_j, *[jnp.asarray(inputs[k]) for k in
                                                        ("pts", "normals", "view", "feats")],
                                          inter=True)
    with torch.no_grad():
        _, _, (c_t, o_t, inter_t) = _port(params_j, inputs, inter=True)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=atol)
    np.testing.assert_allclose(o_t["occ_prob"].numpy(), np.asarray(o_j["occ_prob"]), atol=atol)
    np.testing.assert_allclose(o_t["reflective"].numpy(), np.asarray(o_j["reflective"]),
                               atol=1e-5)
    assert set(inter_t) == set(inter_j)
    for k in inter_j:
        np.testing.assert_allclose(inter_t[k].numpy(), np.asarray(inter_j[k]),
                                   atol=atol if reference == "xla" else 5e-3, err_msg=k)


def test_grads_match_xla_f32(setup):
    """Every param leaf, normals and feats: normalised max error < 1e-4."""
    params_j, inputs, cots = setup
    for a, b in zip(_jax_grads("xla", params_j, inputs, cots), _port_grads(params_j, inputs, cots)):
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b / scale, a / scale, atol=1e-4)


def test_grads_vs_tpu_kernel_at_its_bar(setup):
    """tests/test_shader_kernel.py's bar: the bf16 kernel's mean error against
    f32 (here: the port's plain version) under 4x the bf16-XLA path's + 1e-3,
    and every leaf within cosine 0.99."""
    params_j, inputs, cots = setup
    g32 = _port_grads(params_j, inputs, cots)
    gbf = _jax_grads("bf16", params_j, inputs, cots)
    gk = _jax_grads("fused", params_j, inputs, cots)

    def worst_mean_rel(ga, gb):
        return max(float((np.abs(a - b) / (np.abs(a).max() + 1e-8)).mean()) for a, b in zip(ga, gb))

    assert worst_mean_rel(g32, gk) < 4.0 * worst_mean_rel(g32, gbf) + 1e-3
    for a, b in zip(g32, gk):
        a, b = a.ravel(), b.ravel()
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12) > 0.99


def test_packed_layout(setup):
    params_j, inputs, _ = setup
    p = from_numpy_tree(params_j)
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    with torch.no_grad():
        out = shader.shader_raw(p, AppShadingConfig(), t["pts"], t["normals"], t["view"],
                                t["feats"])
    assert out.shape == (R, S, shader.OUT)
    assert torch.all(out[..., 19:] == 0)
    raw = shader.unpack_raw(out)
    assert raw["NoV"].shape == (R, S, 1) and raw["reflective"].shape == (R, S, 3)


def test_variants_raise_on_the_card_path():
    """Both variants are kernel variants now (tests/test_torch_shader_variants.py),
    and so are the other encodings (ide_deg 1-5, light_pos_freq 0-128); what
    still raises is a topology the kernel does not have, and a human light
    without its poses."""
    cfg = AppShadingConfig(sphere_direction=True)
    assert shader.supported(cfg) and shader.supported(AppShadingConfig(human_light=True))
    assert not shader.supported(AppShadingConfig(ide_deg=6))
    assert shader.supported(AppShadingConfig(light_pos_freq=17))
    assert shader.supported(AppShadingConfig(light_pos_freq=shader.MAX_LIGHT_PE))
    assert not shader.supported(AppShadingConfig(light_pos_freq=shader.MAX_LIGHT_PE + 1))
    assert shader.supported(AppShadingConfig(ide_deg=4))
    assert shader.supported(AppShadingConfig(light_pos_freq=6))
    with pytest.raises(ValueError):
        app_shading_apply({}, AppShadingConfig(human_light=True), None,
                          *([torch.zeros(1, 3)] * 3), torch.zeros(1, 256))


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version(setup):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    params_j, inputs, _ = setup
    dev = torch.device("cuda")
    p = from_numpy_tree(params_j, device=dev)
    t = [torch.from_numpy(inputs[k]).to(dev) for k in ("pts", "normals", "view", "feats")]
    with torch.no_grad():
        k = shader.shader_raw(p, AppShadingConfig(), *t)
        ref = shader.shader_raw_plain(p, AppShadingConfig(), *t)
    torch.testing.assert_close(k[..., 15:19], ref[..., 15:19], atol=1e-5, rtol=0)
    torch.testing.assert_close(k, ref, atol=3e-2, rtol=3e-2)
