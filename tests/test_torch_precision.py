"""The precision switches of the port (`sdf_grad_mode`, `bf16_hidden`,
`matmul_precision`) against nero_tpu on the CPU, at small widths: the same
weights (bridged from the JAX init) and the same numpy inputs go through
both packages. JAX honours an explicit bf16 storage on the CPU, so the bf16
cases compare like with like.

Tolerances: f32 values rtol 1e-5 / atol 1e-6 and gradients 1e-4 of each
leaf's largest entry (sums in another order). Under bf16 storage an
activation that lands next to a rounding boundary rounds the other way in
one package (2^-8 relative), so values are held to 2e-2 of their largest
entry and gradients to 3e-2 (the bf16 step is 3.9e-3; a few such flips add
up along 4-8 layers). Those bars alone would pass an f32 port, since f32
and bf16 storage differ by about 2^-8 relative: each bf16 case also holds
the port's result to be much nearer nero_tpu's bf16 result than nero_tpu's
f32 result (mean |d| under NEARER times the f32 one's)."""
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nero_tpu.fields import mc_shading as JM
from nero_tpu.fields import sdf as JS
from nero_tpu.ops import mlp as JMLP
from nero_tpu.ops.fg_lut import get_fg_lut as jax_fg_lut
from nero_tpu.render import shape as J
from nero_tpu_torch.core.convert import from_numpy_tree, tree_items
from nero_tpu_torch.fields import app_shading as A
from nero_tpu_torch.fields import mc_shading as TM
from nero_tpu_torch.fields.sdf import SDFConfig
from nero_tpu_torch.ops import mlp as M
from nero_tpu_torch.ops.fg_lut import get_fg_lut
from nero_tpu_torch.ops.sdf_grad import sdf_with_grad
from nero_tpu_torch.render import shape as T

# one intra-op thread: the suite runs several worker processes side by side
torch.set_num_threads(1)

SMALL_SDF = dict(n_layers=4, d_hidden=64, skip=2, multires=6, d_out=17)
BF16_VAL, BF16_GRAD = 2e-2, 3e-2
NEARER = 0.25


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_scaled(a, b, tol, msg="", floor=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), floor)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale, err_msg=msg)


def _nearer_bf16(a, b16, b32, msg=""):
    """The port's bf16-storage result `a` is nearer nero_tpu's bf16 result
    than its f32 one: mean |a - b16| < NEARER * mean |a - b32|."""
    a, b16, b32 = (np.asarray(v, np.float64) for v in (a, b16, b32))
    d16, d32 = np.abs(a - b16).mean(), np.abs(a - b32).mean()
    assert d32 > 0 and d16 < NEARER * d32, f"{msg}: mean |d| {d16:.3e} to bf16, {d32:.3e} to f32"


def _storage(bf16: bool):
    return (JMLP.hidden_dtype(jnp.bfloat16 if bf16 else None),
            M.hidden_dtype(torch.bfloat16 if bf16 else None))


# ---------------------------------------------------------------------------
# sdf_with_grad: rev and fwd, values, spatial gradients, eikonal gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sdf_setup():
    cfg_j, cfg_t = JS.SDFConfig(**SMALL_SDF), SDFConfig(**SMALL_SDF)
    params = jax.tree_util.tree_map(np.asarray, JS.init_sdf(jax.random.PRNGKey(3), cfg_j))
    # move the geometric init off its sphere so every layer carries signal
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), params)
    x = rng.uniform(-0.9, 0.9, (96, 3)).astype(np.float32)
    return cfg_j, cfg_t, params, x


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["rev", "fwd"])
def test_sdf_with_grad_matches(sdf_setup, mode, bf16):
    """Values, d sdf / dx and the weight gradients of an eikonal loss plus
    the sdf's mean, through nero_tpu's `sdf_with_grad(mode)`."""
    cfg_j, cfg_t, params, x = sdf_setup
    ctx_j, ctx_t = _storage(bf16)

    def loss_j(p):
        sdf, feats, grad = JS.sdf_with_grad(p, _j(x), cfg_j, mode=mode)
        eik = jnp.mean((jnp.linalg.norm(grad, axis=-1) - 1.0) ** 2)
        return eik + jnp.mean(sdf) + 0.1 * jnp.mean(feats), (sdf, feats, grad)

    pj = jax.tree_util.tree_map(jnp.asarray, params)
    with ctx_j:
        (lj, (sj, fj, gj)), dj = jax.value_and_grad(loss_j, has_aux=True)(pj)
    pt = from_numpy_tree(params)
    with ctx_t:
        st, ft, gt = sdf_with_grad(pt, _t(x), cfg_t, mode)
        lt = (torch.mean((torch.linalg.norm(gt, dim=-1) - 1.0) ** 2) + torch.mean(st)
              + 0.1 * torch.mean(ft))
    leaves = list(tree_items(pt))
    dt = torch.autograd.grad(lt, [v for _, v in leaves])
    tol_v, tol_g = (BF16_VAL, BF16_GRAD) if bf16 else (1e-5, 1e-4)
    for name, a, b in (("sdf", st, sj), ("feats", ft, fj), ("grad", gt, gj)):
        _close_scaled(a.detach().numpy(), b, tol_v, name)
    assert float(lt.detach()) == pytest.approx(float(lj), rel=tol_v)
    dj = dict(tree_items(jax.tree_util.tree_map(np.asarray, dj)))
    for (k, _), g in zip(leaves, dt):
        _close_scaled(g.numpy(), dj[k], tol_g, f"d loss / d {k}")
    if bf16:
        (_, (s32, f32, g32)), d32 = jax.value_and_grad(loss_j, has_aux=True)(pj)
        for name, a, b16, b32 in (("sdf", st, sj, s32), ("feats", ft, fj, f32),
                                  ("grad", gt, gj, g32)):
            _nearer_bf16(a.detach().numpy(), b16, b32, name)
        d32 = dict(tree_items(jax.tree_util.tree_map(np.asarray, d32)))
        flat = lambda d: np.concatenate([np.ravel(d[k]) for k, _ in leaves])
        _nearer_bf16(np.concatenate([g.numpy().ravel() for g in dt]), flat(dj), flat(d32),
                     "d loss / d params")


def test_fwd_and_rev_agree_in_f32(sdf_setup):
    """Both modes compute the same function (f32, no storage context)."""
    _, cfg_t, params, x = sdf_setup
    pt = from_numpy_tree(params)
    rev = sdf_with_grad(pt, _t(x), cfg_t, "rev")
    fwd = sdf_with_grad(pt, _t(x), cfg_t, "fwd")
    for a, b in zip(rev, fwd):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_fused_is_the_plain_version_on_cpu(sdf_setup):
    _, cfg_t, params, x = sdf_setup
    pt = from_numpy_tree(params)
    for a, b in zip(sdf_with_grad(pt, _t(x), cfg_t, "fused"),
                    sdf_with_grad(pt, _t(x), cfg_t, "rev")):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="sdf_grad_mode"):
        sdf_with_grad(pt, _t(x), cfg_t, "backward")


# ---------------------------------------------------------------------------
# the bf16 product of apply_dense
# ---------------------------------------------------------------------------


def test_apply_dense_bf16_product_matches_jax():
    """Under a forced "bf16" product mode apply_dense is
    jnp.dot(x.astype(bf16), w.astype(bf16), preferred_element_type=f32) + b
    (f32 sums in another order: rtol 1e-6 of the row scale); its cotangent
    products take bf16 operands and give f32, as JAX transposes a dot under
    the default precision on a TPU."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((200, 40)).astype(np.float32)
    w = rng.standard_normal((40, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    ref = np.asarray(jnp.dot(_j(x).astype(jnp.bfloat16), _j(w).astype(jnp.bfloat16),
                             preferred_element_type=jnp.float32) + _j(b))
    xt, wt = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    with M.product_mode("bf16"):
        y = M.apply_dense({"w": wt, "b": _t(b)}, xt)
    assert y.dtype == torch.float32
    _close_scaled(y.detach().numpy(), ref, 1e-6)
    f32 = M.apply_dense({"w": _t(w), "b": _t(b)}, _t(x))
    assert (y - f32).abs().max() > 1e-3          # the operands were rounded
    gy = rng.standard_normal(y.shape).astype(np.float32)
    gx, gw = torch.autograd.grad(y, (xt, wt), _t(gy))
    bf = lambda a: np.asarray(_j(a).astype(jnp.bfloat16).astype(jnp.float32))
    _close_scaled(gx.numpy(), bf(gy) @ bf(w).T, 1e-6)
    _close_scaled(gw.numpy(), bf(x).T @ bf(gy), 1e-6)


def test_matmul_precision_names():
    """nero_tpu's names resolve to a product mode on CUDA and to f32 on the
    CPU; an unknown name raises."""
    for name, mode in M.MATMUL_PRECISIONS.items():
        assert M.resolve_matmul_precision(name, "cuda") == mode
        assert M.resolve_matmul_precision(name, "cpu") == "f32"
    assert M.resolve_matmul_precision("default", "cuda") == "bf16"
    assert M.resolve_matmul_precision("high", "cuda") == "tf32"
    with pytest.raises(ValueError, match="matmul_precision"):
        M.resolve_matmul_precision("medium", "cuda")


def test_product_mode_sets_and_restores_tf32():
    before = M.set_tf32(False)
    try:
        assert M.current_product_mode() == "f32"
        with M.product_mode("tf32"):
            assert M.current_product_mode() == "tf32"
            assert M.set_tf32(True) is True
            with M.product_mode("bf16"):
                assert M.current_product_mode() == "bf16"
                assert M.set_tf32(False) is False
            assert M.set_tf32(True) is True
        assert M.set_tf32(False) is False
        assert M.current_product_mode() == "f32"
    finally:
        M.set_tf32(before)


def test_hidden_storage_context():
    x = torch.randn(4, 8)
    assert M.cast_hidden(x) is x and M.current_hidden_dtype() is None
    with M.hidden_dtype(torch.bfloat16):
        assert M.cast_hidden(x).dtype == torch.bfloat16
        with M.hidden_dtype(torch.float32):
            assert M.cast_hidden(x) is x
        assert M.current_hidden_dtype() == torch.bfloat16
    assert M.current_hidden_dtype() is None


# ---------------------------------------------------------------------------
# the resolution table
# ---------------------------------------------------------------------------

# (sdf_grad_mode, bf16_hidden, device) -> (grad mode, bf16 storage, whole-shader kernel)
RESOLUTION = [
    (None, None, "cpu", "rev", False, False),
    (None, None, "cuda", "fused", True, True),
    (None, True, "cpu", "rev", True, True),
    (None, True, "cuda", "fused", True, True),
    (None, False, "cpu", "rev", False, False),
    (None, False, "cuda", "rev", False, False),
    ("rev", None, "cpu", "rev", False, False),
    ("rev", None, "cuda", "rev", True, True),
    ("fwd", None, "cpu", "fwd", False, False),
    ("fwd", None, "cuda", "fwd", True, True),
    ("fwd", False, "cuda", "fwd", False, False),
    ("fwd", True, "cpu", "fwd", True, True),
    ("fused", None, "cuda", "fused", True, True),
    ("fused", False, "cuda", "fused", False, False),
    ("fused", None, "cpu", "rev", False, False),
    ("fused", True, "cpu", "rev", True, True),
]


@pytest.mark.parametrize("mode,bf16,device,grad,storage,kernel", RESOLUTION)
def test_resolution_table(mode, bf16, device, grad, storage, kernel):
    """The port's resolution with CUDA in the TPU's place, held to nero_tpu's
    wherever that does not depend on the backend (nero_tpu runs on the CPU
    here: its unset bf16_hidden and its `fused` resolve as on a non-TPU)."""
    cfg = {k: v for k, v in (("sdf_grad_mode", mode), ("bf16_hidden", bf16)) if v is not None}
    scfg = T.shape_config_from_dict(cfg)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = scfg.resolved(device)
    downgraded = mode == "fused" and grad == "rev"
    assert any("taking 'rev'" in str(w.message) for w in caught) == downgraded
    assert got.sdf_grad_mode == grad and got.bf16_hidden == storage
    dtype = torch.bfloat16 if storage else torch.float32
    assert scfg.hidden_act_dtype(device) == dtype
    assert A.fused_shader_active(scfg.shader, dtype) == kernel
    assert not A.fused_shader_active(scfg.shader._replace(fused_shader=False), dtype)
    assert A.fused_shader_active(scfg.shader._replace(fused_shader=True), dtype)
    scfg_j = J.shape_config_from_dict(cfg)
    if bf16 is not None or device == "cpu":
        assert (scfg_j.hidden_act_dtype == jnp.bfloat16) == storage
    if mode in ("rev", "fwd") or device == "cpu":
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert scfg_j.grad_mode == grad


def test_grad_mode_of_another_sdf_topology():
    """The kernel takes nero_tpu's SDF topology at multires 1-20: unset
    resolves to `rev` on CUDA for another one (multires 21 is past nero_tpu's
    PE_PAD of 128), `fused` warns and takes `rev`; multires 4 takes the
    kernel."""
    for over in ({"sdf_n_layers": 6}, {"sdf_freq": 21}, {"sdf_d_out": 129}):
        scfg = T.shape_config_from_dict(over)
        assert scfg.resolved("cuda").sdf_grad_mode == "rev"
        with pytest.warns(RuntimeWarning, match="taking 'rev'"):
            assert scfg._replace(sdf_grad_mode="fused").grad_mode("cuda") == "rev"
    assert T.shape_config_from_dict({"sdf_freq": 4}).resolved("cuda").sdf_grad_mode == "fused"


@pytest.mark.parametrize("key,value", [("sdf_grad_mode", "backward"), ("sdf_grad_mode", "FUSED"),
                                       ("bf16_hidden", "yes"), ("bf16_hidden", 1.0)])
def test_unknown_values_raise(key, value):
    with pytest.raises(ValueError, match=key):
        T.shape_config_from_dict({key: value})
    if key == "bf16_hidden":
        with pytest.raises(ValueError, match=key):
            TM.mc_config_from_dict({key: value})


def test_stage2_storage_resolution():
    for bf16, device, want in ((None, "cuda", torch.bfloat16), (None, "cpu", torch.float32),
                               (True, "cpu", torch.bfloat16), (False, "cuda", torch.float32)):
        cfg = TM.MCShadingConfig(bf16_hidden=bf16)
        assert cfg.hidden_act_dtype(device) == want
        assert cfg.resolved(device).bf16_hidden == (want == torch.bfloat16)
        if bf16 is not None:
            assert (JM.MCShadingConfig(bf16_hidden=bf16).hidden_act_dtype == jnp.bfloat16) == \
                (want == torch.bfloat16)


# ---------------------------------------------------------------------------
# the render core and the Stage-II shader under bf16 storage
# ---------------------------------------------------------------------------

R = 24
TINY_CFG = {"n_samples": 16, "n_importance": 8, "up_sample_steps": 2, "n_bg_samples": 4,
            "train_ray_num": R, "test_ray_num": R, "occ_loss_step": 5, "anneal_end": 100,
            "perturb": 0.0, "sdf_n_layers": 4, "bf16_hidden": True}


def _rays(seed=0):
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((R, 3))
    o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + rng.uniform(-0.4, 0.4, (R, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    mid = -np.sum(o * d, -1, keepdims=True)
    near, far = np.maximum(mid - 1.0, 1e-3), mid + 1.0
    return [a.astype(np.float32) for a in (o, d, near, far)]


def test_render_core_bf16_hidden_matches():
    """Stage I's sampler and render core (a validation render: the training
    outputs and the validation maps) with `bf16_hidden: true`: the port's
    whole-shader path (plain on the CPU) and nero_tpu's per-head path store
    the same activations in bf16. The outputs are colours, probabilities and
    depths of order 1, where a bf16 flip inside a head moves an output by
    ~2^-8 whatever its own size: each is held to 2e-2 of max(its largest
    entry, 0.1)."""
    is_train = False
    scfg_j, scfg_t = J.shape_config_from_dict(dict(TINY_CFG)), \
        T.shape_config_from_dict(dict(TINY_CFG))
    params = jax.tree_util.tree_map(np.asarray,
                                    J.init_shape_params(jax.random.PRNGKey(0), scfg_j))
    o, d, near, far = _rays()
    pj = JMLP.resolve_weight_norm(jax.tree_util.tree_map(jnp.asarray, params))
    zi, zo = J.sample_z_vals(pj, scfg_j, _j(o), _j(d), _j(near), _j(far), perturb=0.0)
    out_j = J.render_core(pj, scfg_j, _j(jax_fg_lut()), _j(o), _j(d),
                          jnp.concatenate([zi, zo], -1), jnp.zeros((R, 3, 4)), 0.5, 2,
                          is_train=is_train, key=jax.random.PRNGKey(0))
    with torch.no_grad():
        pt = M.resolve_weight_norm(from_numpy_tree(params))
        zi_t, zo_t = T.sample_z_vals(pt, scfg_t, _t(o), _t(d), _t(near), _t(far), perturb=0.0)
        # the sampler inverts a CDF of bf16 SDF values: a value that rounds
        # the other way moves a new sample by up to ~0.5% of its depth
        _close_scaled(zi_t.numpy(), np.asarray(zi), 1e-2, "inner z")
        # the core on the same z values
        out_t = T.render_core(pt, scfg_t, _t(get_fg_lut()), _t(o), _t(d),
                              _t(np.concatenate([zi, zo], -1)), (0.5, 0.5), 2, is_train=is_train,
                              gen=torch.Generator().manual_seed(0))
    assert set(out_t) == set(out_j)
    for k in out_j:
        _close_scaled(out_t[k].numpy(), np.asarray(out_j[k]), BF16_VAL, k, floor=0.1)
    # nero_tpu's f32 storage on the same z values: every output that the
    # storage moves is much nearer nero_tpu's bf16 output
    scfg_32 = J.shape_config_from_dict({**TINY_CFG, "bf16_hidden": False})
    out_32 = J.render_core(pj, scfg_32, _j(jax_fg_lut()), _j(o), _j(d),
                           jnp.concatenate([zi, zo], -1), jnp.zeros((R, 3, 4)), 0.5, 2,
                           is_train=is_train, key=jax.random.PRNGKey(0))
    moved = [k for k in out_j if np.any(np.asarray(out_j[k]) != np.asarray(out_32[k]))]
    assert "ray_rgb" in moved
    for k in moved:
        _nearer_bf16(out_t[k].numpy(), out_j[k], out_32[k], k)


def test_mc_shading_apply_bf16_hidden_matches():
    """Stage II's shader with `bf16_hidden: true` (PN points, 16 + 8
    directions, an analytic sphere tracer): colours and outputs."""
    kw = dict(diffuse_sample_num=16, specular_sample_num=8, human_lights=True,
              bf16_hidden=True)
    cfg_j, cfg_t = JM.MCShadingConfig(**kw), TM.MCShadingConfig(**kw)
    params = jax.tree_util.tree_map(np.asarray, JM.init_mc_shading(jax.random.PRNGKey(1), cfg_j))
    rng = np.random.default_rng(2)
    n = rng.standard_normal((6, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    pts, normals = 0.8 * n, -n + 0.5 * rng.standard_normal((6, 3))
    view = normals + 0.7 * rng.standard_normal((6, 3))
    poses = np.tile(np.concatenate([np.eye(3), [[0.0], [0.0], [3.0]]], 1), (6, 1, 1))
    args = [a.astype(np.float32) for a in (pts, view, normals, poses)]

    def trace(xp, o, dd):
        kw_ = {"axis": -1} if xp is jnp else {"dim": -1}
        b = xp.sum(o * dd, **kw_)
        disc = b * b - (xp.sum(o * o, **kw_) - 0.25)
        t = -b - xp.sqrt(xp.maximum(disc, xp.zeros_like(disc)))
        hit = (disc > 0) & (t > 1e-4)
        t = xp.where(hit, t, 10.0 * xp.ones_like(t))
        p = o + dd * t[:, None]
        return p, xp.where(hit[:, None], -p / 0.5, xp.zeros_like(p)), t[:, None], hit

    cj, oj = JM.mc_shading_apply(jax.tree_util.tree_map(jnp.asarray, params), cfg_j,
                                 JM.make_direction_samples(cfg_j),
                                 lambda o, dd: trace(jnp, o, dd), *[_j(a) for a in args])
    with torch.no_grad():
        ct, ot = TM.mc_shading_apply(from_numpy_tree(params), cfg_t,
                                     TM.make_direction_samples(cfg_t),
                                     lambda o, dd: trace(torch, o, dd), *[_t(a) for a in args])
    _close_scaled(ct.numpy(), np.asarray(cj), BF16_VAL, "colors")
    for k in oj:
        _close_scaled(ot[k].numpy(), np.asarray(oj[k]), BF16_VAL, k)
    # the heads of the materials and the human light: much nearer nero_tpu's
    # bf16 outputs than its f32 ones. The outputs of the other light heads
    # are not held so: their IDE inputs carry an f32 noise between the two
    # packages (the degree-5 terms move with the last bit of their input)
    # that is 10-75% of what the storage moves them by at this init;
    # `test_predictor_bf16_storage_matches` holds those heads on shared inputs
    _, o32j = JM.mc_shading_apply(jax.tree_util.tree_map(jnp.asarray, params),
                                  cfg_j._replace(bf16_hidden=False),
                                  JM.make_direction_samples(cfg_j),
                                  lambda o, dd: trace(jnp, o, dd), *[_j(a) for a in args])
    for k in ("albedo", "roughness", "metallic", "human_lights"):
        _nearer_bf16(ot[k].numpy(), oj[k], o32j[k], k)
    # bf16 storage moved the result: it is not the f32 shader's
    with torch.no_grad():
        c32, _ = TM.mc_shading_apply(from_numpy_tree(params), cfg_t._replace(bf16_hidden=False),
                                     TM.make_direction_samples(cfg_t),
                                     lambda o, dd: trace(torch, o, dd), *[_t(a) for a in args])
    assert (c32 - ct).abs().max() > 0


# (input width, output width, final activation, exp clamp) of Stage II's heads
STAGE2_HEADS = [(259, 3, "sigmoid", 0.0), (72, 3, "exp", 5.0), (123, 3, "exp", 5.0),
                (24, 4, "exp", 5.0)]


@pytest.mark.parametrize("d_in,d_out,act,exp_max", STAGE2_HEADS,
                         ids=["material", "inner_light", "outer_light", "human_light"])
def test_predictor_bf16_storage_matches(d_in, d_out, act, exp_max):
    """A 4-layer head under bf16 storage on the same inputs (128 rows, the
    weights of nero_tpu's init): within BF16_VAL of nero_tpu's and much
    nearer its bf16 result than its f32 one."""
    layers = jax.tree_util.tree_map(
        np.asarray, JMLP.init_predictor(jax.random.PRNGKey(d_in), d_in, d_out))
    x = np.random.default_rng(d_in).standard_normal((128, d_in)).astype(np.float32)
    run_j = lambda: np.asarray(JMLP.apply_predictor(
        jax.tree_util.tree_map(jnp.asarray, layers), _j(x), act, exp_max))
    with JMLP.hidden_dtype(jnp.bfloat16):
        y16 = run_j()
    y32 = run_j()
    with torch.no_grad(), M.hidden_dtype(torch.bfloat16):
        yt = M.apply_predictor(from_numpy_tree(layers), _t(x), act, exp_max).numpy()
    _close_scaled(yt, y16, BF16_VAL, "head")
    _nearer_bf16(yt, y16, y32, "head")


@pytest.mark.parametrize("fused_shader", [None, False], ids=["whole_shader", "per_head"])
def test_remat_shader_keeps_the_storage(fused_shader):
    """remat_shader recomputes the shader in the backward pass, outside the
    render core's storage context: the recompute stores in bf16 as the
    forward did, so the gradients are those of the run without remat."""
    from nero_tpu_torch.models.shape import NeROShapeModel
    from nero_tpu_torch.render.rays import sample_ray_batch

    cfg = {"name": "remat", "network": "shape", "database_name": "proc/sphere/32_6",
           **{k: v for k, v in TINY_CFG.items() if k not in ("perturb",)},
           "shader_config": {"fused_shader": fused_shader}}
    grads = []
    for remat in (False, True):
        model = NeROShapeModel({**cfg, "remat_shader": remat}, device="cpu")
        d = model.train_data
        batch = sample_ray_batch(torch.Generator().manual_seed(0), d["imgs_u8"], d["K_inv"],
                                 d["poses"], R, d["human_poses"])
        loss, _ = model.loss_fn(model.params, batch, 0, torch.Generator().manual_seed(1))
        grads.append(torch.autograd.grad(loss, model.parameters()))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _remat_model_cfg(fused_shader):
    return {"name": "remat", "network": "shape", "database_name": "proc/sphere/32_6",
            **{k: v for k, v in TINY_CFG.items() if k not in ("perturb",)},
            "shader_config": {"fused_shader": fused_shader}}


def _grads_on_another_thread(loss, params):
    """torch.autograd.grad run on a thread of its own, as autograd runs the
    backward of CUDA tensors on its device thread: no context of the
    calling thread reaches it."""
    out = {}

    def run():
        try:
            out["grads"] = torch.autograd.grad(loss, params)
        except Exception as e:            # re-raised on the calling thread
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "error" in out:
        raise out["error"]
    return out["grads"]


@pytest.mark.parametrize("fused_shader", [None, False], ids=["whole_shader", "per_head"])
def test_remat_shader_keeps_the_product_mode(fused_shader):
    """remat_shader's recompute re-enters the forward's product mode as well
    as its storage: under a forced "bf16" product and bf16 storage, with the
    backward on another thread (where the recompute runs on the card), the
    gradients are those of the run without remat."""
    from nero_tpu_torch.models.shape import NeROShapeModel
    from nero_tpu_torch.render.rays import sample_ray_batch

    grads = []
    for remat in (False, True):
        model = NeROShapeModel({**_remat_model_cfg(fused_shader), "remat_shader": remat},
                               device="cpu")
        d = model.train_data
        batch = sample_ray_batch(torch.Generator().manual_seed(0), d["imgs_u8"], d["K_inv"],
                                 d["poses"], R, d["human_poses"])
        with M.product_mode("bf16"):
            loss, _ = model.loss_fn(model.params, batch, 0, torch.Generator().manual_seed(1))
        grads.append(_grads_on_another_thread(loss, list(model.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.gpu
def test_remat_shader_under_default_precision_on_cuda():
    """On the card, the per-head shader under `matmul_precision: default`
    and the resolved bf16 storage: remat_shader on and off give the same
    parameter gradients (each leaf within 1e-5 of its largest entry: the
    backward's sums may take another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: autograd's device thread exists only there")
    from nero_tpu_torch.models.shape import NeROShapeModel
    from nero_tpu_torch.render.rays import sample_ray_batch

    dev = torch.device("cuda")
    cfg = {k: v for k, v in _remat_model_cfg(False).items() if k != "bf16_hidden"}
    grads = []
    for remat in (False, True):
        model = NeROShapeModel({**cfg, "remat_shader": remat}, device=dev)
        assert model.scfg.bf16_hidden
        d = model.train_data
        batch = sample_ray_batch(torch.Generator(device=dev).manual_seed(0), d["imgs_u8"],
                                 d["K_inv"], d["poses"], R, d["human_poses"])
        params = list(model.parameters())
        with M.product_mode(M.resolve_matmul_precision("default", dev)):
            loss, _ = model.loss_fn(model.params, batch, 0,
                                    torch.Generator(device=dev).manual_seed(1))
            grads.append(torch.autograd.grad(loss, params))
    for a, b in zip(*grads):
        _close_scaled(b.cpu().numpy(), a.cpu().numpy(), 1e-5)
