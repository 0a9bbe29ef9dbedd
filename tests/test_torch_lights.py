"""ops/lights.py of the port on the CPU: the plain version of the light kernel
against nero_tpu's UNFUSED light path (`predict_outer_lights`,
`get_inner_lights`) in f32, values and gradients, on the same weights
(bridged from the JAX init) and the same numpy inputs; against the TPU kernel
`lights_fused_raw` in interpret mode at its own test's bar; and `get_lights`
with `fused_lights=True` against nero_tpu's `get_lights`. Tolerances: values
rtol 1e-4 / atol 1e-5 (f32 sums in another order); a gradient leaf at rtol
1e-4 with a floor of 5e-4 of its own largest entry (PE8's top octave
amplifies the ~1e-7 difference of the two packages' sin/cos). Gradients are
compared at ide_deg = 4: at 5 both packages carry ~1e-2 of f32 noise near the
poles. The CUDA kernel itself is held against the plain version on the card
by chip_smoke.py and by the `gpu`-marked test."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nero_tpu.fields import mc_shading as J
from nero_tpu.ops.mlp import exp_activation as exp_jax
from nero_tpu.ops.pallas.light_kernel import lights_fused_raw
from nero_tpu_torch.core.convert import from_numpy_tree, tree_items
from nero_tpu_torch.fields import mc_shading as T
from nero_tpu_torch.ops import lights as L
from nero_tpu_torch.ops.mlp import exp_activation

# one intra-op thread: the suite runs several worker processes side by side
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a_t, a_j, rtol=RTOL, atol=ATOL, msg=""):
    a_t = a_t.detach().numpy() if torch.is_tensor(a_t) else np.asarray(a_t)
    np.testing.assert_allclose(a_t, np.asarray(a_j), rtol=rtol, atol=atol, err_msg=msg)


def _setup(version="direction", p=2, s=24, seed=0, **kw):
    """(JAX cfg, port cfg, JAX params, port params, numpy inputs)."""
    base = dict(human_lights=False, outer_light_version=version, bf16_hidden=False, **kw)
    cfg_j, cfg_t = J.MCShadingConfig(**base), T.MCShadingConfig(**base)
    pj = jax.tree_util.tree_map(np.asarray, J.init_mc_shading(jax.random.PRNGKey(seed), cfg_j))
    rng = np.random.default_rng(seed + 1)
    # some points beyond radius 0.999: the sphere_direction clamp is exercised
    pts = rng.uniform(-0.62, 0.62, (p, s, 3)).astype(np.float32)
    dirs = rng.standard_normal((p, s, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    inters = rng.uniform(-0.6, 0.6, (p, s, 3)).astype(np.float32)
    normals = rng.standard_normal((p, s, 3)).astype(np.float32)
    return (cfg_j, cfg_t, jax.tree_util.tree_map(jnp.asarray, pj), from_numpy_tree(pj),
            (pts, dirs, inters, normals))


def _unfused_jax(pj, cfg_j, pts, dirs, inters, normals):
    return (J.get_inner_lights(pj, cfg_j, inters, -dirs, normals),
            J.predict_outer_lights(pj, cfg_j, pts, dirs))


@pytest.mark.parametrize("mode", ["both", "outer"])
@pytest.mark.parametrize("version", ["direction", "sphere_direction"])
def test_plain_matches_unfused_values(version, mode):
    cfg_j, cfg_t, pj, pt, arrs = _setup(version)
    inner_j, outer_j = _unfused_jax(pj, cfg_j, *map(_j, arrs))
    with torch.no_grad():
        inner_z, outer_z = L.lights_raw_plain(pt, cfg_t, *map(_t, arrs), mode=mode)
    _close(exp_activation(outer_z, cfg_t.light_exp_max), outer_j, msg="outer")
    if mode == "both":
        _close(exp_activation(inner_z, cfg_t.inner_light_exp_max), inner_j, msg="inner")
    else:
        assert float(inner_z.abs().max()) == 0.0 and inner_z.shape == outer_z.shape


def test_odd_shapes():
    """P = 3, S = 7: no padding to any tile on the plain path."""
    cfg_j, cfg_t, pj, pt, arrs = _setup("direction", p=3, s=7)
    inner_j, outer_j = _unfused_jax(pj, cfg_j, *map(_j, arrs))
    with torch.no_grad():
        inner_z, outer_z = L.lights_raw(pt, cfg_t, *map(_t, arrs))
    assert inner_z.shape == (3, 7, 3) and outer_z.shape == (3, 7, 3)
    _close(exp_activation(inner_z, 5.0), inner_j)
    _close(exp_activation(outer_z, 5.0), outer_j)


@pytest.mark.parametrize("mode", ["both", "outer"])
@pytest.mark.parametrize("version", ["direction", "sphere_direction"])
def test_plain_gradients_match_unfused(version, mode):
    """Gradients to both heads' parameters, the points and the directions
    against jax.grad of the unfused path. With `sphere_direction` this is the
    check that the sphere hit point is NOT normalised (the TPU kernel
    normalises it, which changes d points and d directions)."""
    cfg_j, cfg_t, pj, pt, arrs = _setup(version, ide_deg=4, seed=3)
    pts, dirs, inters, normals = arrs
    rng = np.random.default_rng(9)
    cot_i = rng.standard_normal(pts.shape).astype(np.float32) * (mode == "both")
    cot_o = rng.standard_normal(pts.shape).astype(np.float32)
    heads_j = {k: pj[k] for k in ("inner_light", "outer_light")}

    def loss_j(heads, p, d):
        inner, outer = _unfused_jax({**pj, **heads}, cfg_j, p, d, _j(inters), _j(normals))
        return jnp.sum(inner * cot_i) + jnp.sum(outer * cot_o)

    g_heads, g_p, g_d = jax.grad(loss_j, argnums=(0, 1, 2))(heads_j, _j(pts), _j(dirs))

    p_t, d_t = _t(pts).requires_grad_(True), _t(dirs).requires_grad_(True)
    inner_z, outer_z = L.lights_raw_plain(pt, cfg_t, p_t, d_t, _t(inters), _t(normals),
                                          mode=mode)
    loss_t = (torch.sum(exp_activation(inner_z, 5.0) * _t(cot_i))
              + torch.sum(exp_activation(outer_z, 5.0) * _t(cot_o)))
    heads_t = {k: pt[k] for k in heads_j}
    items = list(tree_items(heads_t))
    grads = torch.autograd.grad(loss_t, [v for _, v in items] + [p_t, d_t], allow_unused=True)
    got = {k: (np.zeros(tuple(v.shape), np.float32) if g is None else g.numpy())
           for (k, v), g in zip(items, grads)}
    want = dict(tree_items(jax.tree_util.tree_map(np.asarray, g_heads)))
    got["points"] = np.zeros_like(pts) if grads[-2] is None else grads[-2].numpy()
    got["dirs"] = grads[-1].numpy()
    want["points"], want["dirs"] = np.asarray(g_p), np.asarray(g_d)
    assert set(got) == set(want)
    for k, gj in want.items():
        scale = max(float(np.abs(gj).max()), 1e-6)
        np.testing.assert_allclose(got[k], gj, rtol=RTOL, atol=5e-4 * scale, err_msg=k)
    assert float(np.abs(want["dirs"]).max()) > 0
    assert (float(np.abs(want["points"]).max()) > 0) == (version == "sphere_direction")
    if mode == "both":
        assert float(np.abs(want["inner_light|0|v"]).max()) > 0


def test_hit_points_and_normals_get_no_gradient():
    """They come from the tracer detached; the kernel returns none for them
    and the plain version detaches them too."""
    _, cfg_t, _, pt, arrs = _setup()
    pts, dirs, inters, normals = (_t(a).requires_grad_(True) for a in arrs)
    inner_z, outer_z = L.lights_raw_plain(pt, cfg_t, pts, dirs, inters, normals)
    g = torch.autograd.grad(inner_z.sum() + outer_z.sum(), [inters, normals, dirs],
                            allow_unused=True)
    assert g[0] is None and g[1] is None and g[2] is not None


@pytest.mark.parametrize("version", ["direction", "sphere_direction"])
def test_plain_matches_pallas_interpret(version):
    """The TPU kernel in interpret mode (bf16 weights and operands) against
    the f32 plain version, at tests/test_light_kernel.py's bar: atol 3e-3
    after exp. (The forward of the two agrees also for sphere_direction: a
    hit point on the unit sphere is its own normalisation to 5e-7.)"""
    cfg_j, cfg_t, pj, pt, arrs = _setup(version, p=2, s=48)
    inner_zj, outer_zj = lights_fused_raw(pj, cfg_j, *map(_j, arrs), mode="both", interpret=True)
    with torch.no_grad():
        inner_z, outer_z = L.lights_raw_plain(pt, cfg_t, *map(_t, arrs))
    _close(exp_activation(inner_z, 5.0), exp_jax(inner_zj, 5.0), rtol=0, atol=3e-3)
    _close(exp_activation(outer_z, 5.0), exp_jax(outer_zj, 5.0), rtol=0, atol=3e-3)


def _fake_trace(xp):
    """Deterministic tracer of tests/test_light_kernel.py: hit iff dir z > 0."""
    def fn(o, d):
        hit = d[:, 2] > 0
        depth = (jnp.full((o.shape[0], 1), 0.5) if xp is jnp
                 else torch.full((o.shape[0], 1), 0.5))
        return o + 0.1 * d, -d, depth, hit
    return fn


@pytest.mark.parametrize("inner_frac", [0.0, 0.75], ids=["both_heads", "outer_head_only"])
@pytest.mark.parametrize("version", ["direction", "sphere_direction"])
def test_get_lights_fused_matches_jax(version, inner_frac):
    """The routing of get_lights: mode `both` without compaction, `outer`
    with inner compaction on; exp, hit select and near mask outside."""
    cfg_j, cfg_t, pj, pt, arrs = _setup(version, p=4, s=64, inner_compact_frac=inner_frac)
    pts, dirs = arrs[0], arrs[1]
    ref = J.get_lights(pj, cfg_j, _fake_trace(jnp), _j(pts), _j(dirs), None)
    calls = []
    real = T.lights_raw
    T.lights_raw = lambda *a, **k: (calls.append(k["mode"]), real(*a, **k))[1]
    try:
        with torch.no_grad():
            out = T.get_lights(pt, cfg_t._replace(fused_lights=True), _fake_trace(torch),
                               _t(pts), _t(dirs), None)
    finally:
        T.lights_raw = real
    assert calls == ["outer" if inner_frac else "both"]
    for name, a, b in zip(("lights", "human", "inters", "normals"), out, ref):
        _close(a, b, msg=name)
    assert (out[4].numpy() == np.asarray(ref[4])).all()


def test_unsupported_configuration_takes_the_unfused_path():
    """outer compaction on (or ide_deg > 5): a rule about the configuration.
    get_lights warns once and does not call the fused wrapper."""
    cfg_j, cfg_t, pj, pt, arrs = _setup(p=4, s=64, outer_compact_frac=0.75)
    ref = J.get_lights(pj, cfg_j, _fake_trace(jnp), _j(arrs[0]), _j(arrs[1]), None)
    real = T.lights_raw
    T.lights_raw = None     # a call would raise
    try:
        with pytest.warns(RuntimeWarning, match="outer_compact_frac=0.75"), torch.no_grad():
            out = T.get_lights(pt, cfg_t._replace(fused_lights=True), _fake_trace(torch),
                               _t(arrs[0]), _t(arrs[1]), None)
    finally:
        T.lights_raw = real
    _close(out[0], ref[0])
    assert not T.fused_lights_active(cfg_t._replace(fused_lights=True, ide_deg=6))


@pytest.mark.parametrize("sphere,both", [(False, True), (True, True), (False, False),
                                         (True, False)])
def test_pack_and_unpack_roundtrip(sphere, both):
    """The kernel layout: heads in HEAD_ORDER, first layer padded to 128
    (inner), 80 or 144 (outer) rows and the last to 16 columns with zeros,
    bf16; unpack_grads cuts the same slices back out."""
    version = "sphere_direction" if sphere else "direction"
    _, cfg_t, _, pt, _ = _setup(version)
    mode = "both" if both else "outer"
    ws, bs = L.pack_light_params(pt, cfg_t, mode)
    assert len(ws) == len(bs) == (8 if both else 4)
    d_outer = 144 if sphere else 72
    assert tuple(ws[-4].shape) == (d_outer, 256) and tuple(ws[-1].shape) == (256, 3)
    W, B = L.pack_buffers(ws, bs, sphere, both)
    assert W.dtype == torch.bfloat16 and W.numel() == L.weight_elems(sphere, both)
    assert tuple(B.shape) == (2 if both else 1, 4, 256)
    shapes = [tuple(w.shape) for w in ws]
    dws, dbs = L.unpack_grads(W.float(), B, shapes, sphere, both)
    for w, b, dw, db in zip(ws, bs, dws, dbs):
        assert dw.shape == w.shape and db.shape == b.shape
        torch.testing.assert_close(dw, w.detach().to(torch.bfloat16).float())
        torch.testing.assert_close(db, b.detach())
    # padding is zero: the padded total equals the unpadded total
    assert float(W.float().abs().sum()) == pytest.approx(
        float(sum(w.detach().to(torch.bfloat16).float().abs().sum() for w in ws)), rel=1e-5)
    # gradients reach the weight-norm leaves through the resolved weights
    g = torch.autograd.grad(sum(w.sum() for w in ws), pt["outer_light"][0]["v"])
    assert g[0].abs().max() > 0


def test_wrapper_runs_plain_on_cpu_tensors():
    _, cfg_t, _, pt, arrs = _setup("sphere_direction")
    before = dict(L.launches)
    with torch.no_grad():
        a = L.lights_raw(pt, cfg_t, *map(_t, arrs), mode="both")
        b = L.lights_raw_plain(pt, cfg_t, *map(_t, arrs), mode="both")
    assert L.launches == before            # no kernel launch for CPU tensors
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError):
        L.lights_raw(pt, cfg_t, *map(_t, arrs), mode="inner")


def test_work_per_launch():
    """393,216 rows, both heads at their true widths (123 and 72 inputs):
    627,200 operations a row forward; backward the hidden layers'
    recompute, every dW, and dX down to the columns that carry a gradient
    (the inner head's 72 IDE columns, all 72 of the outer head's)."""
    cfg = T.MCShadingConfig()
    assert L.flops_per_row(cfg) == 2 * ((123 * 256 + 2 * 256 * 256 + 256 * 3)
                                        + (72 * 256 + 2 * 256 * 256 + 256 * 3))
    assert L.flops(393216, cfg) == pytest.approx(2.466e11, rel=1e-3)
    recompute = (123 + 72) * 256 + 2 * 2 * 256 * 256
    dw = L.flops_per_row(cfg) / 2
    dx = 2 * (256 * 3 + 2 * 256 * 256 + 72 * 256)
    assert L.bwd_flops_per_row(cfg) == 2 * (recompute + dw + dx) == 1852416
    assert L.flops(393216, cfg, backward=True) == 393216 * 1852416
    sph = cfg._replace(outer_light_version="sphere_direction")
    assert L.bwd_flops_per_row(sph, "outer") == 2 * (
        (144 * 256 + 2 * 256 * 256) + 2 * (144 * 256 + 2 * 256 * 256 + 256 * 3))
    assert L.flops_per_row(cfg, "outer") < 0.5 * L.flops_per_row(cfg)
    assert L.min_bytes(393216, cfg) == 393216 * 18 * 4 + L.weight_elems(False, True) * 2
    assert L.supported(cfg) and not L.supported(cfg._replace(ide_deg=6))
    assert L.supported(cfg._replace(ide_deg=4))


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    for version, mode in (("direction", "both"), ("sphere_direction", "outer")):
        _, cfg_t, _, pt, arrs = _setup(version, p=8, s=100)
        pt = jax.tree_util.tree_map(lambda a: a.detach().to(dev).requires_grad_(True), pt)
        args = [_t(a).to(dev) for a in arrs]
        args[1].requires_grad_(True)
        out_k = L.lights_raw(pt, cfg_t, *args, mode=mode)
        out_p = L.lights_raw_plain(pt, cfg_t, *args, mode=mode)
        for a, b in zip(out_k, out_p):
            assert (torch.exp(a) - torch.exp(b)).abs().max() < 3e-3
        g_k = torch.autograd.grad(sum(o.sum() for o in out_k), args[1])[0]
        g_p = torch.autograd.grad(sum(o.sum() for o in out_p), args[1])[0]
        cos = (g_k.flatten() @ g_p.flatten()) / (g_k.norm() * g_p.norm())
        assert cos > 0.98


@pytest.mark.parametrize("ide_deg", range(1, 7))
def test_resolver_agrees_with_the_kernel(ide_deg):
    """`fused_lights=True` reaches the kernel exactly where ops/lights.py::
    supported takes the configuration (ide_deg <= 5, nero_tpu's rule), and
    warns exactly where it does not, taking the unfused path: the one rule
    of what the kernel takes, so no configuration passes the resolver and
    raises on the card."""
    cfg = T.MCShadingConfig(fused_lights=True, ide_deg=ide_deg)
    takes = L.supported(cfg)
    assert takes == (ide_deg <= L.MAX_IDE_DEG)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        active = T.fused_lights_active(cfg)
    assert active == takes
    warned = [w for w in caught if issubclass(w.category, RuntimeWarning)
              and "unfused light path" in str(w.message)]
    assert bool(warned) == (not takes)
    if not takes:
        assert f"ide_deg={ide_deg}" in str(warned[0].message)
