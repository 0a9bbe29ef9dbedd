"""The multi-scene step as one program (models/multi_scene.py, parallel/
scenes.py) on the CPU: the scene-batched SDF-with-gradient and whole-shader
functions (`sdf_with_grad_scenes`, `shader_raw_scenes`) against `jax.vmap`
of nero_tpu's Pallas kernels in interpret mode, and to the bit against their
one-scene plain versions scene by scene; the batched step's loss and every
gradient leaf against `jax.vmap` of nero_tpu's render and losses over
stacked parameters; a few batched steps against each scene trained alone;
the kernels' scene layout against the sources; and a non-CPU tensor that
reaches a batched wrapper without a library, which raises.

Bars: against the Pallas kernels those of tests/test_torch_sdf_grad.py (sdf
atol 5e-3 rtol 1e-2, grad 2e-2 / 5e-2, mean |d feats| < 5e-3, parameter
gradients 2e-2 of each leaf's max, loss rtol 1e-2) and of
tests/test_torch_shader_variants.py (colour and occ_prob atol 2e-3; the
gradients' worst mean error under 4x the bf16-XLA path's + 2e-3 and every
leaf within cosine 0.98); the step against nero_tpu's render, that of
tests/test_torch_shape_e2e.py::test_new_configs_loss_and_grads_match_jax
(loss rtol 1e-4, each gradient leaf within 1e-3 of its max or of 1e-2 of
the step's largest gradient); against the scenes alone and the one-scene
plain versions, equal to the bit. (The CPU's elementwise kernels run a SIMD
body of 32 floats and a scalar tail, whose transcendental functions round
differently: the row counts here are multiples of 64, so that a scene's
elements take the same path batched and alone. On the card each element
takes the same code wherever it lies.)"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_common as C
from nero_tpu.fields.app_shading import (AppShadingConfig as JCfg, _app_shading_apply_fused,
                                         app_shading_apply as jax_apply, init_app_shading)
from nero_tpu.fields.sdf import SDFConfig as JSDFConfig, init_sdf
from nero_tpu.ops.fg_lut import get_fg_lut as jax_fg_lut
from nero_tpu.ops.mlp import hidden_dtype
from nero_tpu.ops.pallas.sdf_grad_kernel import sdf_with_grad_fused
from nero_tpu.render import shape as J
from nero_tpu.train.losses import compute_losses as jax_compute_losses, total_loss as jax_total
from nero_tpu_torch.core.convert import from_numpy_tree, tree_items, tree_map
from nero_tpu_torch.fields.app_shading import (AppShadingConfig, app_shading_apply,
                                               shade_from_raw)
from nero_tpu_torch.fields.sdf import SDFConfig
from nero_tpu_torch.models.multi_scene import MultiSceneShapeModel
from nero_tpu_torch.models.shape import NeROShapeModel
from nero_tpu_torch.ops import cuda_build, sdf_grad, shader
from nero_tpu_torch.ops.fg_lut import get_fg_lut
from nero_tpu_torch.ops.mlp import resolve_weight_norm
from nero_tpu_torch.parallel.scenes import (n_scenes, per_row, scene_map, scene_slice,
                                            scene_sum, stack_trees)
from nero_tpu_torch.render.rays import human_coordinate_poses
from test_torch_shape_e2e import R as RAYS, TINY_CFG, _parity_rays
from torch_csrc import source_constants

torch.set_num_threads(1)

S = 2


def _stack_np(trees):
    return jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *trees)


# ---------------------------------------------------------------------------
# (a) B1 with the scene axis against jax.vmap of nero_tpu's kernel
# ---------------------------------------------------------------------------

N_PTS = 128


@pytest.fixture(scope="module")
def sdf_setup():
    params = [jax.tree_util.tree_map(np.asarray, init_sdf(jax.random.PRNGKey(3 + s), JSDFConfig()))
              for s in range(S)]
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.7, 0.7, (S, N_PTS, 3)).astype(np.float32)
    cot = (rng.standard_normal((S, N_PTS, 256)) * 0.1).astype(np.float32)
    return params, _stack_np(params), pts, cot


def _sdf_loss(sdf, feats, grad, cot, lib):
    eik = lib.mean((lib.linalg.norm(grad, axis=-1) - 1.0) ** 2) if lib is jnp else \
        ((torch.linalg.norm(grad, dim=-1) - 1.0) ** 2).mean()
    return (sdf ** 2).mean() + 0.1 * eik + (feats * cot).mean()


def _port_sdf(stacked_np, pts, cot):
    p = from_numpy_tree(stacked_np)
    out = sdf_grad.sdf_with_grad_scenes(p, torch.from_numpy(pts), SDFConfig())
    loss = sum(_sdf_loss(*(o[s] for o in out), torch.from_numpy(cot[s]), torch)
               for s in range(S))
    loss.backward()
    return out, loss, p


def test_sdf_scenes_against_vmapped_pallas_kernel(sdf_setup):
    _, stacked, pts, cot = sdf_setup
    kernel = lambda p, x: sdf_with_grad_fused(p, x, JSDFConfig(), interpret=True)
    ref = jax.vmap(kernel)(stacked, jnp.asarray(pts))
    assert [tuple(r.shape) for r in ref] == [(S, N_PTS, 1), (S, N_PTS, 256), (S, N_PTS, 3)]

    def loss_j(p):
        outs = jax.vmap(kernel)(p, jnp.asarray(pts))
        return sum(_sdf_loss(*(o[s] for o in outs), jnp.asarray(cot[s]), jnp) for s in range(S))

    val_j, g_j = jax.jit(jax.value_and_grad(loss_j))(stacked)
    (sdf, feats, grad), loss, p = _port_sdf(stacked, pts, cot)
    np.testing.assert_allclose(sdf.detach().numpy(), np.asarray(ref[0]), atol=5e-3, rtol=1e-2)
    np.testing.assert_allclose(grad.detach().numpy(), np.asarray(ref[2]), atol=2e-2, rtol=5e-2)
    assert np.abs(feats.detach().numpy() - np.asarray(ref[1])).mean() < 5e-3
    np.testing.assert_allclose(loss.item(), float(val_j), rtol=1e-2)
    got = dict(tree_items(p))
    for k, a in tree_items(jax.tree_util.tree_map(np.asarray, g_j)):
        assert got[k].shape[0] == S
        for s in range(S):  # each scene's leaf by its own max
            scale = np.abs(a[s]).max() + 1e-8
            np.testing.assert_allclose(got[k].grad[s].numpy() / scale, a[s] / scale, atol=2e-2,
                                       err_msg=f"{k}[{s}]")


def test_sdf_scenes_are_the_one_scene_plain_version(sdf_setup):
    params, stacked, pts, cot = sdf_setup
    (sdf, feats, grad), _, p = _port_sdf(stacked, pts, cot)
    for s in range(S):
        one = from_numpy_tree(params[s])
        out = sdf_grad.sdf_with_grad_plain(one, torch.from_numpy(pts[s]), SDFConfig())
        assert all(torch.equal(a[s], b) for a, b in zip((sdf, feats, grad), out))
        _sdf_loss(*out, torch.from_numpy(cot[s]), torch).backward()
        got = dict(tree_items(p))
        for k, leaf in tree_items(one):
            assert torch.equal(got[k].grad[s], leaf.grad), (s, k)


@pytest.mark.parametrize("mode", ["rev", "fwd"])
def test_sdf_scenes_other_modes_go_scene_by_scene(sdf_setup, mode):
    params, stacked, pts, _ = sdf_setup
    p = from_numpy_tree(stacked)
    with torch.no_grad():
        out = sdf_grad.sdf_with_grad_scenes(p, torch.from_numpy(pts), SDFConfig(), mode)
        for s in range(S):
            one = sdf_grad.sdf_with_grad(from_numpy_tree(params[s]), torch.from_numpy(pts[s]),
                                         SDFConfig(), mode)
            assert all(torch.equal(a[s], b) for a, b in zip(out, one)), s
    with pytest.raises(ValueError, match="sdf_grad_mode"):
        sdf_grad.sdf_with_grad_scenes(p, torch.from_numpy(pts), SDFConfig(), "bwd")


# ---------------------------------------------------------------------------
# (a) B2 with the scene axis, four variants, against jax.vmap of nero_tpu's kernel
# ---------------------------------------------------------------------------

R, K = 2, 32
VARIANTS = {"default": {}, "sphere": dict(sphere_direction=True),
            "human": dict(human_light=True),
            "both": dict(sphere_direction=True, human_light=True)}
ROWS = ("pts", "normals", "view", "feats")


def _shader_setup(variant):
    """tests/test_torch_shader_variants.py's regime, S scenes of [R, K] rows."""
    kw = VARIANTS[variant]
    params = [jax.tree_util.tree_map(np.asarray, init_app_shading(jax.random.PRNGKey(s), JCfg(**kw)))
              for s in range(S)]
    rng = np.random.default_rng(11)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    q, _ = np.linalg.qr(rng.standard_normal((S, R, K, 3, 3)))
    hp = np.concatenate([q, rng.uniform(-0.5, 0.5, (S, R, K, 3, 1))], -1).astype(np.float32)
    inputs = {"pts": rng.uniform(-0.6, 0.6, (S, R, K, 3)).astype(np.float32),
              "normals": f(S, R, K, 3), "view": f(S, R, K, 3), "feats": f(S, R, K, 256) * 0.3,
              "hp": hp}
    inputs["pts"][:, 0, :4] *= 2.5  # a few points outside radius 0.999
    return kw, params, _stack_np(params), inputs, (f(S, R, K, 3), f(S, R, K, 1))


@pytest.fixture(scope="module", params=list(VARIANTS))
def shader_setup(request):
    return _shader_setup(request.param)


def _jax_shade(kind, kw):
    lut = jnp.asarray(jax_fg_lut())

    def f(p, pts, nrm, view, feats, hp):
        if kind == "fused":
            return _app_shading_apply_fused(p, JCfg(**kw), lut, pts, nrm, view, feats, hp, False,
                                            interpret=True)
        with hidden_dtype(jnp.bfloat16):
            return jax_apply(p, JCfg(fused_shader=False, **kw), lut, pts, nrm, view, feats, hp)
    return jax.vmap(f)


def _jax_shader_grads(kind, kw, stacked, inputs, cots):
    fn = _jax_shade(kind, kw)

    def loss(p, pts, nrm, view, ft):
        c, o = fn(p, pts, nrm, view, ft, jnp.asarray(inputs["hp"]))
        return jnp.sum(c * cots[0]) + jnp.sum(o["occ_prob"] * cots[1])
    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        stacked, *[jnp.asarray(inputs[k]) for k in ROWS])
    return [a for _, a in tree_items(jax.tree_util.tree_map(np.asarray, g[0]))] + \
        [np.asarray(a) for a in g[1:]]


def _port_shader(kw, stacked, inputs, cots=None):
    """The whole-shader path over S scenes (`shader_raw_scenes` on scene-major
    rows), its colour and occ_prob [S, R, K, ...], and with `cots` the
    gradients of every stacked leaf and of the row inputs."""
    p = from_numpy_tree(stacked)
    t = {k: torch.from_numpy(v.reshape((S * R,) + v.shape[2:])).requires_grad_(k != "hp")
         for k, v in inputs.items()}
    cfg = AppShadingConfig(**kw)
    # weight norm resolved first, as the renderer resolves it once a step
    raw = shader.shader_raw_scenes(resolve_weight_norm(p), cfg, S, *[t[k] for k in ROWS], t["hp"])
    c, o = shade_from_raw(raw, cfg, torch.from_numpy(get_fg_lut()))
    c, occ = c.reshape(S, R, K, 3), o["occ_prob"].reshape(S, R, K, 1)
    if cots is None:
        return raw, c, occ, None
    loss = (c * torch.from_numpy(cots[0])).sum() + (occ * torch.from_numpy(cots[1])).sum()
    leaves = [v for _, v in tree_items(p)] + [t[k] for k in ROWS]
    grads = [g.reshape((S, R) + g.shape[1:]) if i >= len(leaves) - 4 else g
             for i, g in enumerate(torch.autograd.grad(loss, leaves))]
    return raw, c, occ, [g.numpy() for g in grads]


def test_shader_scenes_forward_against_vmapped_pallas_kernel(shader_setup):
    kw, _, stacked, inputs, _ = shader_setup
    c_k, o_k = _jax_shade("fused", kw)(stacked, *[jnp.asarray(inputs[k]) for k in ROWS + ("hp",)])
    with torch.no_grad():
        _, c_t, occ_t, _ = _port_shader(kw, stacked, inputs)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_k), atol=2e-3)
    np.testing.assert_allclose(occ_t.numpy(), np.asarray(o_k["occ_prob"]), atol=2e-3)


def test_shader_scenes_grads_against_vmapped_pallas_kernel(shader_setup):
    kw, _, stacked, inputs, cots = shader_setup
    _, _, _, g32 = _port_shader(kw, stacked, inputs, cots)
    gbf = _jax_shader_grads("bf16", kw, stacked, inputs, cots)
    gk = _jax_shader_grads("fused", kw, stacked, inputs, cots)

    def worst_mean_rel(ga, gb):
        return max(float((np.abs(a - b) / (np.abs(a).max() + 1e-8)).mean())
                   for a, b in zip(ga, gb))

    assert worst_mean_rel(g32, gk) < 4.0 * worst_mean_rel(g32, gbf) + 2e-3
    for a, b in zip(g32, gk):
        a, b = a.ravel(), b.ravel()
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        if denom >= 1e-12:
            assert a @ b / denom > 0.98
    if kw.get("human_light"):
        hnorm = sum(np.linalg.norm(g) for (k, _), g in zip(tree_items(stacked), g32)
                    if k.startswith("human"))
        assert hnorm > 1e-6, "the human head got no gradient: the test is vacuous"


def test_shader_scenes_are_the_one_scene_plain_version(shader_setup):
    """Values and every gradient of the whole-shader path, and of the
    per-head path through `app_shading_apply(n_scenes=S)`, scene by scene."""
    kw, params, stacked, inputs, cots = shader_setup
    raw, _, _, g_b = _port_shader(kw, stacked, inputs, cots)
    n_leaves = len(list(tree_items(stacked)))
    for s in range(S):
        one = {k: v[s] for k, v in inputs.items()}
        _, _, _, g_1 = _port_one(kw, params[s], one, [c[s] for c in cots])
        with torch.no_grad():
            raw_1 = shader.shader_raw_plain(from_numpy_tree(params[s]), AppShadingConfig(**kw),
                                            *[torch.from_numpy(one[k]) for k in ROWS + ("hp",)])
        assert torch.equal(raw.detach()[s * R:(s + 1) * R], raw_1)
        for i, (a, b) in enumerate(zip(g_b, g_1)):
            assert np.array_equal(a[s], b), i if i < n_leaves else ROWS[i - n_leaves]
    # the per-head path: each scene's heads on its rows
    p = from_numpy_tree(stacked)
    t = [torch.from_numpy(inputs[k].reshape((S * R,) + inputs[k].shape[2:]))
         for k in ROWS + ("hp",)]
    lut = torch.from_numpy(get_fg_lut())
    cfg = AppShadingConfig(fused_shader=False, **kw)
    with torch.no_grad():
        c, _ = app_shading_apply(p, cfg, lut, *t, n_scenes=S)
        for s in range(S):
            c1, _ = app_shading_apply(from_numpy_tree(params[s]), cfg, lut,
                                      *[x[s * R:(s + 1) * R] for x in t])
            assert torch.equal(c[s * R:(s + 1) * R], c1)


def _port_one(kw, params, inputs, cots):
    p = from_numpy_tree(params)
    t = {k: torch.from_numpy(v).requires_grad_(k != "hp") for k, v in inputs.items()}
    cfg = AppShadingConfig(**kw)
    raw = shader.shader_raw_plain(resolve_weight_norm(p), cfg, *[t[k] for k in ROWS], t["hp"])
    c, o = shade_from_raw(raw, cfg, torch.from_numpy(get_fg_lut()))
    loss = (c * torch.from_numpy(cots[0])).sum() + (o["occ_prob"] * torch.from_numpy(cots[1])).sum()
    leaves = [v for _, v in tree_items(p)] + [t[k] for k in ROWS]
    return raw, c, o, [g.numpy() for g in torch.autograd.grad(loss, leaves)]


# ---------------------------------------------------------------------------
# (b) the batched step's loss and gradients against jax.vmap of nero_tpu's
# ---------------------------------------------------------------------------

# every masked candidate is selected in the occlusion loss, so the random
# scores (different generators in the two packages) drop out
PARITY_CFG = {**TINY_CFG, "perturb": 0.0, "occ_loss_max_pn": RAYS * 24}
STEP_CFGS = {"sphere": {}, "real": {"shader_config": {"human_light": True}}}


def _scene_rays(model, s):
    """tests/test_torch_shape_e2e.py::_parity_rays, each scene with the
    'human' poses of its cameras from camera s on."""
    rays = _parity_rays(model)
    poses = human_coordinate_poses(model.train_data["poses"], model.cfg["fixed_camera"])
    rays["human_poses"] = poses[(torch.arange(RAYS) + s) % poses.shape[0]].numpy()
    return rays


@pytest.mark.parametrize("which,step", [("sphere", 3), ("sphere", 6), ("real", 6)],
                         ids=["sphere-before_occ", "sphere-occ_phase", "real-occ_phase"])
def test_batched_step_loss_and_grads_match_vmapped_jax(which, step):
    cfg = {**PARITY_CFG, **STEP_CFGS[which]}
    scfg_j = J.shape_config_from_dict(dict(cfg))
    cfgs = [{**cfg, "name": f"scene{s}"} for s in range(S)]
    # each scene at tests/test_torch_shape_e2e.py's point (PRNGKey(0), its rays),
    # scene s with its cameras' human poses from camera s on. (Elsewhere a
    # valid occlusion candidate can sit within f32 noise of a ReLU kink of a
    # head and carry a few percent of a leaf's gradient: at nero_tpu's
    # multi-scene init, seed 6033, the occlusion head's layer-1 gradient moves
    # by 1.9e-2 of its max under a 3e-7 relative change of the parameters, in
    # the one-scene step as in this one.)
    params_j = jax.tree_util.tree_map(np.asarray,
                                      J.init_shape_params(jax.random.PRNGKey(0), scfg_j))
    stacked = _stack_np([params_j] * S)
    ms = MultiSceneShapeModel(cfgs, device="cpu")
    rays = [_scene_rays(ms.models[s], s) for s in range(S)]
    rays_j = {k: jnp.asarray(np.stack([r[k] for r in rays])) for k in rays[0]}

    def loss_j(p, r):
        out = J.render(p, scfg_j, jnp.asarray(jax_fg_lut()), r["rays_o"], r["rays_d"],
                       r["near"], r["far"], r["human_poses"], step, key=jax.random.PRNGKey(0),
                       is_train=True, perturb_overwrite=0.0)
        out["loss_rgb"] = J.compute_rgb_loss(out["ray_rgb"], r["rgb"], "charbonier")
        return jax_total(jax_compute_losses(cfg["loss"], out, None, step, cfg))

    totals_j = jax.jit(jax.vmap(loss_j))(jax.tree_util.tree_map(jnp.asarray, stacked), rays_j)
    val_j, g_j = jax.jit(jax.value_and_grad(lambda p: jnp.sum(jax.vmap(loss_j)(p, rays_j))))(
        jax.tree_util.tree_map(jnp.asarray, stacked))
    ms.params = from_numpy_tree(stacked)
    assert n_scenes(ms.params) == S
    batch = {k: torch.from_numpy(np.concatenate([r[k] for r in rays])) for k in rays[0]}
    gens = [torch.Generator().manual_seed(s) for s in range(S)]
    loss_t, totals, logs = ms.loss_fn(ms.params, batch, step, gens)
    loss_t.backward()
    for s in range(S):
        assert (float(logs[s]["loss_occ"].detach()) > 0.0) == (step >= cfg["occ_loss_step"])
        np.testing.assert_allclose(totals[s].item(), float(totals_j[s]), rtol=1e-4)
    np.testing.assert_allclose(loss_t.item(), float(val_j), rtol=1e-4)
    grads_j = list(tree_items(jax.tree_util.tree_map(np.asarray, g_j)))
    if which == "real":
        assert any(k.startswith("shader|human_light") for k, _ in grads_j)
    got = dict(tree_items(ms.params))
    assert set(got) == {k for k, _ in grads_j}
    for s in range(S):
        floor = 1e-2 * max(np.abs(a[s]).max() for _, a in grads_j)
        for k, a in grads_j:
            b = got[k].grad
            b = np.zeros_like(a[s]) if b is None else b[s].numpy()
            scale = max(np.abs(a[s]).max(), floor)
            np.testing.assert_allclose(b / scale, a[s] / scale, atol=1e-3, err_msg=f"{k}[{s}]")


# ---------------------------------------------------------------------------
# (c) a few batched steps against each scene trained alone
# ---------------------------------------------------------------------------

ALONE_CFGS = {"sphere": {}, "real": {"shader_config": {"human_light": True}},
              "heads": {"shader_config": {"fused_shader": False, "fused_heads": True},
                        "use_fused_sdf": True}}
LR_CFG = {"end_warm": 1, "end_iter": 10, "lr": 1e-3}


def _alone(cfg, s, steps):
    model = NeROShapeModel({**cfg, "random_seed": cfg.get("random_seed", 6033) + s},
                           device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    logs = [C._numpy(model.train_step(opt, i)) for i in range(steps)]
    return logs, C._params(model.params)


@pytest.mark.parametrize("which,n", [("sphere", 3), ("real", 2), ("heads", 2)])
def test_batched_steps_are_each_scene_alone(which, n):
    """Seven steps (into the occlusion phase, occ_loss_step 5): each scene's
    parameters and log equal to the bit to the scene trained alone with seed
    random_seed + s."""
    steps = 7
    cfgs = [{**TINY_CFG, **ALONE_CFGS[which], "name": f"scene{s}", "lr_cfg": LR_CFG}
            for s in range(n)]
    ms = MultiSceneShapeModel(cfgs, device="cpu")
    opt = torch.optim.Adam(ms.parameters(), lr=1e-3)
    assert len(opt.param_groups[0]["params"]) == len(list(tree_items(ms.scene_params(0))))
    logs = [ms.train_step(opt, i) for i in range(steps)]
    assert logs[-1][0]["loss_occ"] > 0.0
    for s in range(n):
        alone_logs, alone = _alone(cfgs[s], s, steps)
        got = C._params(ms.scene_params(s))
        assert all(np.array_equal(got[k], alone[k]) for k in alone), (which, s)
        assert [C._numpy(l[s]) for l in logs] == alone_logs, (which, s)


def test_scene_helpers():
    """per_row's gradient is each scene's block summed whole (as a scalar's
    broadcast over one scene is), scene_sum and scene_map split the rows
    scene-major, scene_slice takes views."""
    v = torch.tensor([2.0, 3.0], requires_grad=True)
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    y = x * per_row(v, x)
    assert torch.equal(y[:2], x[:2] * 2.0) and torch.equal(y[2:], x[2:] * 3.0)
    y.sum().backward()
    assert torch.equal(v.grad, torch.stack([x[:2].sum(), x[2:].sum()]))
    s0 = torch.tensor(2.0)
    assert per_row(s0, x) is s0
    assert torch.equal(scene_sum(x, 2), torch.stack([x[:2].sum(), x[2:].sum()]))
    assert torch.equal(scene_sum(x, None), x.sum())
    tree = {"a": [torch.ones(2, 3) * torch.tensor([[1.0], [2.0]])]}
    out = scene_map(lambda p, r: r * p["a"][0], 2, tree, x[:, :3])
    assert torch.equal(out, torch.cat([x[:2] * 1.0, x[2:] * 2.0]))
    assert scene_slice(tree, 1)["a"][0]._base is tree["a"][0]
    st = stack_trees([{"w": torch.zeros(3)}, {"w": torch.ones(3)}])
    assert st["w"].shape == (2, 3) and st["w"].requires_grad and st["w"].is_leaf


# ---------------------------------------------------------------------------
# (d) the kernels' scene layout against the sources
# ---------------------------------------------------------------------------


def _sdf_sizes(n: int, scenes: int) -> tuple:
    """(bf16 scratch elements, f32 partials) of sdf_grad.cu for S scenes of n
    rows: each scene padded to the tile alone, S times one scene's Scratch
    and chunk partials."""
    c = source_constants(("sdf_grad.cu", "sdf_net.cuh"),
                         ("P", "HID", "OUTW", "PEW", "PW_MIN_ROWS", "W_TOTAL"))
    n_pad = -(-n // c["P"]) * c["P"]
    m = 4 * n_pad
    chunks = min(max(m // c["PW_MIN_ROWS"], 1), 64)
    part_row = c["W_TOTAL"] + 9 * c["OUTW"]
    return n_pad, scenes * (16 * m * c["HID"] + m * (c["OUTW"] + c["PEW"])), \
        scenes * chunks * part_row


def test_kernel_scene_layout_mirrors_the_sources():
    text = {f: open(f"{cuda_build.CSRC}/{f}").read() for f in ("sdf_grad.cu", "shader.cu")}
    g = text["sdf_grad.cu"]
    # B1: a scene's rows follow the scenes before it, gridDim.x tiles a scene;
    # its weights, biases, scratch and partials the s-th of S equal parts
    assert g.count("(blockIdx.y * gridDim.x + blockIdx.x) * P") == 2
    assert len(re.findall(r"^ +W \+= blockIdx\.y \* \(size_t\)W_TOTAL;", g, re.M)) == 2
    assert g.count("bias += blockIdx.y * 9 * OUTW;") == 2
    assert "Scratch(scratch + blockIdx.z * Scratch::elems(M), M)" in g
    assert "part += (size_t)blockIdx.y * n_chunks * PART_ROW;" in g
    assert re.search(r"sdf_grad_fwd_kernel<<<dim3\(n_pad / P, n_scenes\)", g)
    assert re.search(r"sdf_bwd_params_kernel<<<dim3\(PW_TILES, n_chunks, n_scenes\)", g)
    # B2: the scene's row arrays n rows a scene further on, its weights a set further on
    h = text["shader.cu"]
    for stride in ("geo += sc_ * n * L::GEO;", "feats += sc_ * n * HID;",
                   "rows += sc_ * n * OUT;", "W += sc_ * L::w_total();",
                   "B += sc_ * L::NHEADS * 4 * HID;",
                   "dgeo += blockIdx.y * (size_t)n * DGEO;",
                   "BwdScratch<L>(scratch + blockIdx.z * BwdScratch<L>::elems(M), M)"):
        assert stride in h, stride
    assert h.count("SCENE_OFFSETS(") == 3  # the macro, the forward, the sweep
    # the per-scene padding: 1,001 rows a scene are 1,024 each, not 2,002 -> 2,016
    n_pad, scratch, part = _sdf_sizes(1001, 2)
    one = _sdf_sizes(1001, 1)
    assert n_pad == 1024 and (scratch, part) == (2 * one[1], 2 * one[2])
    # 2.32 GB of scratch a scene at the training lattice's 65,536 rows
    assert _sdf_sizes(65536, 4)[1] == 4 * _sdf_sizes(65536, 1)[1] == 4 * 1_157_627_904
    c = source_constants(("sdf_grad.cu", "sdf_net.cuh"), ("P", "W_TOTAL", "OUTW"))
    assert c["P"] == sdf_grad.TILE and c["OUTW"] == sdf_grad.OUT_W


def test_packed_scenes_are_each_scene_packed():
    """pack_scenes of stacked weights: [S, W_TOTAL] and [S, 9, 272] (B1),
    [S, w_total] and [S, heads, 4, 256] (B2), row s scene s's pack; the
    scenes' rows padded to the tile one by one."""
    params = [from_numpy_tree(jax.tree_util.tree_map(
        np.asarray, init_sdf(jax.random.PRNGKey(3 + s), JSDFConfig())), requires_grad=False)
        for s in range(S)]
    layers = resolve_weight_norm(stack_trees(params))
    W, bias = sdf_grad.pack_scenes([l["w"] for l in layers], [l["b"] for l in layers])
    total = source_constants(("sdf_grad.cu", "sdf_net.cuh"), ("W_TOTAL",))["W_TOTAL"]
    assert W.shape == (S, total) and bias.shape == (S, 9, sdf_grad.OUT_W)
    for s in range(S):
        one = resolve_weight_norm(params[s])
        w1, b1 = sdf_grad.pack_weights([l["w"] for l in one], [l["b"] for l in one])
        assert torch.equal(W[s], w1) and torch.equal(bias[s], b1)
    x = torch.randn(S, 1001, 3)
    padded = sdf_grad._pad_rows(x, 1024, 1)
    assert padded.shape == (S, 1024, 3) and torch.equal(padded[:, :1001], x)
    assert not padded[:, 1001:].any()
    kw, sparams, stacked, _, _ = _shader_setup("both")
    cfg = AppShadingConfig(**kw)
    heads, pads = shader.head_order(cfg), shader.head_pad(cfg)
    lay = resolve_weight_norm(from_numpy_tree(stacked, requires_grad=False))
    ws = [l["w"] for h in heads for l in lay[h]]
    bs = [l["b"] for h in heads for l in lay[h]]
    Wb, Bb = shader.pack_scenes(ws, bs, [pads[h] for h in heads])
    assert Wb.shape == (S, shader.weight_elems([pads[h] for h in heads]))
    assert Bb.shape == (S, 7, 4, 256)
    for s in range(S):
        one = resolve_weight_norm(from_numpy_tree(sparams[s], requires_grad=False))
        w1, b1 = shader.pack_weights([l["w"] for h in heads for l in one[h]],
                                     [l["b"] for h in heads for l in one[h]],
                                     [pads[h] for h in heads])
        assert torch.equal(Wb[s], w1) and torch.equal(Bb[s], b1)


class _RecordingLib:
    """A kernel library that launches nothing: it records each C call's
    arguments, answers the size queries by `sizes` and returns 0."""

    def __init__(self, sizes):
        self.sizes, self.calls = sizes, []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return self.sizes(name, args)
        return call


def test_scene_counters_and_tallies(monkeypatch):
    """A launch for S scenes counts once, under a name of its own, with the
    FLOPs of S x n rows; it is the scenes' entry with S (one scene: S = 1)
    and buffers S times one scene's."""
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("Stream", (), {"cuda_stream": 0})())
    for mod in (sdf_grad, shader):
        monkeypatch.setattr(mod, "launches", dict(mod.launches))
        monkeypatch.setattr(mod, "flop_tally", dict(mod.flop_tally))
    n, scenes = 96, 3
    lib = _RecordingLib(lambda name, args: 64 if "elems" in name else 0)
    monkeypatch.setattr(sdf_grad, "_lib", lambda m=6: lib)
    pts, W, b = torch.zeros(scenes, n, 3), torch.zeros(scenes, 10), torch.zeros(scenes, 9, 272)
    sdf, grad, feats = sdf_grad._fwd(pts, W, b, 100.0, 1.0)
    assert (sdf.shape, grad.shape, feats.shape) == ((scenes, n), (scenes, n, 3),
                                                    (scenes, n, 256))
    dW, db = sdf_grad._bwd(pts, W, b, 100.0, 1.0, torch.zeros(scenes, n),
                           torch.zeros(scenes, n, 3), torch.zeros(scenes, n, 256))
    assert dW.shape == (scenes, 10) and db.shape == (scenes, 9, 272)
    sdf_grad._fwd(pts[0], W[0], b[0], 100.0, 1.0)
    launched = [(name, args[1:3]) for name, args in lib.calls if not name.endswith("elems")]
    assert launched == [("sdf_grad_fwd_scenes", (n, scenes)), ("sdf_grad_bwd_scenes", (n, scenes)),
                        ("sdf_grad_fwd_scenes", (n, 1))]
    assert sdf_grad.launches["sdf_grad_fwd_scenes"] == 1 == sdf_grad.launches["sdf_grad_fwd"]
    assert sdf_grad.launches["sdf_grad_bwd_scenes"] == 1
    assert sdf_grad.flop_tally["sdf_grad_fwd_scenes"] == sdf_grad.flops(scenes * n)
    assert sdf_grad.flop_tally["sdf_grad_bwd_scenes"] == sdf_grad.flops(scenes * n, True)
    assert sdf_grad.counter("sdf_grad_fwd_scenes", 8) == "sdf_grad_fwd_scenes_m8"
    for sfx, (sp, hu) in (("", (0, 0)), ("_sphere", (1, 0)), ("_human", (0, 1)),
                          ("_sphere_human", (1, 1))):
        cfg = AppShadingConfig(sphere_direction=bool(sp), human_light=bool(hu))
        pads = shader.head_pad(cfg)
        welems = shader.weight_elems([pads[h] for h in shader.head_order(cfg)])
        lib = _RecordingLib(lambda name, args: welems if name == "shader_weight_elems" else
                            64 if "elems" in name else 0)
        monkeypatch.setattr(shader, "_lib", lambda enc=(5, 8): lib)
        geo = torch.zeros(scenes, n, shader.geo_width(cfg))
        feats, Ws = torch.zeros(scenes, n, 256), torch.zeros(scenes, welems)
        Bs = torch.zeros(scenes, len(pads), 4, 256)
        assert shader._fwd(geo, feats, Ws, Bs, sp, hu).shape == (scenes, n, shader.OUT)
        out = shader._bwd(geo, feats, Ws, Bs, sp, hu, torch.zeros(scenes, n, shader.OUT))
        assert [tuple(t.shape) for t in out] == [(scenes, n, 9), (scenes, n, 256),
                                                 (scenes, welems), tuple(Bs.shape)]
        scratch = [args for name, args in lib.calls if name == "shader_scratch_elems"]
        assert scratch == [(n, sp, hu)]  # one scene's size, times S by the wrapper
        for d in ("fwd", "bwd"):
            assert shader.launches[f"shader_{d}_scenes{sfx}"] == 1
            assert shader.launches[f"shader_{d}{sfx}"] == 0
        assert shader.flop_tally[f"shader_bwd_scenes{sfx}"] == shader.flops(scenes * n, cfg, True)


# ---------------------------------------------------------------------------
# (e) off the CPU a batched wrapper launches its kernel or raises
# ---------------------------------------------------------------------------


def test_batched_wrappers_raise_without_a_library(monkeypatch, sdf_setup):
    """A tensor that is not on the CPU (the meta device stands in for the
    card, which this machine lacks) reaches the kernel's library; where none
    can be built the wrapper raises, and the plain version is never called."""
    def no_library(*a, **k):
        raise RuntimeError("no library")

    def plain(*a, **k):
        raise AssertionError("a plain version was called")

    monkeypatch.setattr(cuda_build, "load", no_library)
    monkeypatch.setattr(sdf_grad, "sdf_with_grad_plain", plain)
    monkeypatch.setattr(shader, "shader_raw_plain", plain)
    _, stacked, pts, _ = sdf_setup
    meta = lambda t: t.to("meta")
    p = tree_map(meta, from_numpy_tree(stacked, requires_grad=False))
    with pytest.raises(RuntimeError, match="no library"):
        sdf_grad.sdf_with_grad_scenes(p, torch.from_numpy(pts).to("meta"), SDFConfig())
    _, _, sh_stacked, inputs, _ = _shader_setup("human")
    sp = tree_map(meta, from_numpy_tree(sh_stacked, requires_grad=False))
    rows = [torch.from_numpy(inputs[k].reshape((S * R,) + inputs[k].shape[2:])).to("meta")
            for k in ROWS + ("hp",)]
    with pytest.raises(RuntimeError, match="no library"):
        shader.shader_raw_scenes(sp, AppShadingConfig(human_light=True), S, *rows)
