"""fields/mc_shading.py of the port against nero_tpu on the CPU, f32: the
same weights (bridged from the JAX init), the same numpy inputs and one
analytic tracer (a sphere of radius 0.5 at the origin) go through both.
Where the JAX function draws random numbers inside, the draws are taken from
its keys and handed to the port. Tolerances: rtol 1e-4 / atol 1e-5 on values
(f32 sums in another order); a gradient leaf is compared at rtol 1e-4 with a
floor relative to its own largest entry (`_grad_close`), since some leaves
hold ~1e-6 gradients. Gradient comparisons run at ide_deg = 4: at the
default 5 the l = 16 band of the IDE is a degree-16 polynomial in z whose
~1e4 coefficients cancel, so near the poles both packages carry ~1e-2 of
f32 noise (against a float64 evaluation) and the light heads' gradients agree
to ~1e-2 only; the values are compared at the default degree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nero_tpu.fields import mc_shading as J
from nero_tpu.fields.app_shading import get_camera_plane_intersection as cam_plane_jax
from nero_tpu.ops.mlp import resolve_weight_norm as resolve_jax
from nero_tpu.render.rays import human_coordinate_poses as human_poses_jax
from nero_tpu.utils import sphere as sphere_jax
from nero_tpu.utils.encodings import integrated_pos_encode as ipe_jax
from nero_tpu_torch.core.convert import from_numpy_tree, tree_items
from nero_tpu_torch.fields import mc_shading as T
from nero_tpu_torch.fields.app_shading import get_camera_plane_intersection
from nero_tpu_torch.ops.mlp import resolve_weight_norm
from nero_tpu_torch.render.rays import human_coordinate_poses
from nero_tpu_torch.utils import sphere as sphere_torch
from nero_tpu_torch.utils.encodings import integrated_pos_encode

# one intra-op thread: the suite runs several worker processes side by side
torch.set_num_threads(1)

PN, DN, SN = 6, 32, 16
RTOL, ATOL = 1e-4, 1e-5


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a_t, a_j, rtol=RTOL, atol=ATOL, msg=""):
    a_t = a_t.detach().numpy() if torch.is_tensor(a_t) else np.asarray(a_t)
    np.testing.assert_allclose(a_t, np.asarray(a_j), rtol=rtol, atol=atol, err_msg=msg)


def _cfgs(**kw):
    base = dict(diffuse_sample_num=DN, specular_sample_num=SN, human_lights=False,
                bf16_hidden=False)
    base.update(kw)
    return J.MCShadingConfig(**base), T.MCShadingConfig(**base)


def _params(cfg_j, seed=0):
    pj = jax.tree_util.tree_map(np.asarray, J.init_mc_shading(jax.random.PRNGKey(seed), cfg_j))
    return jax.tree_util.tree_map(jnp.asarray, pj), from_numpy_tree(pj)


def _poses(n, seed=0):
    """World-to-camera poses of cameras on a ring looking at the origin."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        c = rng.standard_normal(3)
        c = 3.0 * c / np.linalg.norm(c)
        z = -c / np.linalg.norm(c)
        x = np.cross(z, [0.0, 0.0, 1.0])
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        out.append(np.concatenate([R, (-R @ c)[:, None]], 1))
    return np.stack(out).astype(np.float32)


def _points(seed=0, radius=0.8):
    """Shading points on a sphere of radius 0.8 around the occluder, with
    perturbed outward normals and view directions."""
    rng = np.random.default_rng(seed)
    n = rng.standard_normal((PN, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    pts = n * radius
    normals = -n + 0.5 * rng.standard_normal((PN, 3))    # facing the occluder
    view = normals + 0.7 * rng.standard_normal((PN, 3))
    human = np.asarray(human_poses_jax(_j(_poses(PN, seed))))
    return (pts.astype(np.float32), view.astype(np.float32), normals.astype(np.float32),
            human.astype(np.float32))


def _sphere_trace(xp, o, d, r=0.5, far=10.0):
    """Analytic first hit of the sphere |p| = r; inward normals, miss =>
    depth far and a zero normal. `xp` is jnp or torch."""
    kw = {"axis": -1} if xp is jnp else {"dim": -1}
    b = xp.sum(o * d, **kw)
    disc = b * b - (xp.sum(o * o, **kw) - r * r)
    sq = xp.sqrt(xp.maximum(disc, xp.zeros_like(disc)))
    t = -b - sq
    hit = (disc > 0) & (t > 1e-4)
    t = xp.where(hit, t, xp.full_like(t, far) if xp is torch else jnp.full_like(t, far))
    inters = o + d * t[:, None]
    normals = xp.where(hit[:, None], -inters / r, xp.zeros_like(inters))
    return inters, normals, t[:, None], hit


trace_j = lambda o, d: _sphere_trace(jnp, o, d)
trace_t = lambda o, d: _sphere_trace(torch, o, d)


def _mask_trace(xp, hit_mask):
    """Ray i hits iff hit_mask[i] (tests/test_compact_inner_light.py)."""
    hits = _j(hit_mask) if xp is jnp else _t(hit_mask)

    def fn(o, d):
        h = hits[: o.shape[0]]
        t = xp.where(h, 0.4, 10.0)[:, None] if xp is jnp else \
            torch.where(h, torch.tensor(0.4), torch.tensor(10.0))[:, None]
        return o + d * t, -d, t, h
    return fn


def _grad_close(g_t: dict, g_j, what=""):
    """Every gradient leaf within RTOL of the JAX one, with an absolute floor
    of 5e-4 of the leaf's largest entry: the inner light reads PE8 of the hit
    points, whose top octave (128 x) amplifies the ~1e-7 difference between
    the two packages' sin/cos, and a few entries of that head's first layer
    then differ by up to 2e-4 of the leaf's largest entry."""
    items_j = dict(tree_items(jax.tree_util.tree_map(np.asarray, g_j)))
    assert set(items_j) == set(g_t)
    for k, gj in items_j.items():
        scale = max(float(np.abs(gj).max()), 1e-6)
        np.testing.assert_allclose(g_t[k], gj, rtol=RTOL, atol=5e-4 * scale,
                                   err_msg=f"{what} grad {k}")


def _torch_grads(loss, params_t) -> dict:
    items = list(tree_items(params_t))
    grads = torch.autograd.grad(loss, [v for _, v in items], allow_unused=True)
    return {k: (np.zeros(tuple(v.shape), np.float32) if g is None else g.numpy())
            for (k, v), g in zip(items, grads)}


# ---------------------------------------------------------------------------
# leaf functions
# ---------------------------------------------------------------------------


def test_direction_lattice_bit_identical():
    cfg_j, cfg_t = _cfgs(diffuse_sample_num=512, specular_sample_num=256)
    sj, st = J.make_direction_samples(cfg_j), T.make_direction_samples(cfg_t)
    assert set(sj) == set(st)
    for k in sj:
        np.testing.assert_array_equal(np.asarray(sj[k]), st[k].numpy(), err_msg=k)


def test_sample_sphere_bit_identical():
    for a, b in zip(sphere_jax.sample_sphere(300, 0), sphere_torch.sample_sphere(300, 0)):
        np.testing.assert_array_equal(a, b)
    az, el = sphere_torch.sample_sphere(64, 0)
    np.testing.assert_array_equal(sphere_jax.az_el_to_points(az, el),
                                  sphere_torch.az_el_to_points(az, el))


def test_ipe_matches():
    rng = np.random.default_rng(0)
    mean = rng.standard_normal((5, 7, 2)).astype(np.float32)
    var = rng.uniform(0, 0.3, (5, 7, 2)).astype(np.float32)
    _close(integrated_pos_encode(_t(mean), _t(var), 0, 6), ipe_jax(_j(mean), _j(var), 0, 6))


@pytest.mark.parametrize("fixed_camera", [False, True])
def test_human_coordinate_poses_match(fixed_camera):
    poses = _poses(5, seed=3)
    _close(human_coordinate_poses(_t(poses), fixed_camera),
           human_poses_jax(_j(poses), fixed_camera), atol=1e-6)


def test_camera_plane_intersection_matches():
    pts, _, normals, human = _points(1)
    for a, b in zip(get_camera_plane_intersection(_t(pts), _t(normals), _t(human)),
                    cam_plane_jax(_j(pts), _j(normals), _j(human))):
        _close(a, b)


def test_orthogonal_directions_match():
    d = np.random.default_rng(0).standard_normal((64, 3)).astype(np.float32)
    d[0] = [0, 0, 1]
    d[1] = [1, 0, 0]
    _close(T.get_orthogonal_directions(_t(d)), J.get_orthogonal_directions(_j(d)), atol=1e-6)


@pytest.mark.parametrize("rotate", [False, True], ids=["lattice", "rotated"])
def test_direction_sampling_matches(rotate):
    """With rotation, the port takes the uniform draws of the JAX key."""
    cfg_j, cfg_t = _cfgs()
    sj, st = J.make_direction_samples(cfg_j), T.make_direction_samples(cfg_t)
    _, _, normals, _ = _points(2)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    rough = np.random.default_rng(1).uniform(0.01, 1.0, (PN, 1)).astype(np.float32)
    key = jax.random.PRNGKey(7) if rotate else None
    rot = _t(np.asarray(jax.random.uniform(key, (PN, 1, 1)))) if rotate else None
    _close(T.sample_diffuse_directions(st["diffuse"], _t(normals), rot=rot),
           J.sample_diffuse_directions(sj["diffuse"], _j(normals), key), atol=2e-5)
    _close(T.sample_specular_directions(st["specular"], _t(normals), _t(rough), rot=rot),
           J.sample_specular_directions(sj["specular"], _j(normals), _j(rough), key),
           atol=2e-5)


def test_generator_rotation_is_a_rotation():
    """Drawn from a torch.Generator, the rotated diffuse directions stay on
    the cosine hemisphere of their normal and differ from the lattice."""
    _, cfg_t = _cfgs()
    st = T.make_direction_samples(cfg_t)
    normals = _t(_points(2)[2])
    normals = normals / torch.linalg.norm(normals, dim=-1, keepdim=True)
    gen = torch.Generator().manual_seed(0)
    a = T.sample_diffuse_directions(st["diffuse"], normals, gen)
    b = T.sample_diffuse_directions(st["diffuse"], normals)
    assert not torch.allclose(a, b)
    torch.testing.assert_close(torch.sum(a * normals[:, None], -1),
                               torch.sum(b * normals[:, None], -1), atol=1e-5, rtol=1e-5)


def test_brdf_terms_match():
    rng = np.random.default_rng(0)
    u = lambda: rng.uniform(0, 1, (PN, 9, 1)).astype(np.float32)
    a, b, r, f0 = u(), u(), u() * 0.99 + 0.0016, rng.uniform(0, 1, (PN, 9, 3)).astype(np.float32)
    _close(T.fresnel_schlick(_t(f0), _t(a)), J.fresnel_schlick(_j(f0), _j(a)))
    _close(T.distribution_ggx(_t(a), _t(r)), J.distribution_ggx(_j(a), _j(r)))
    _close(T.geometry_schlick(_t(a), _t(b), _t(r)), J.geometry_schlick(_j(a), _j(b), _j(r)))
    _close(T.geometry_ggx_smith(_t(a), _t(b), _t(r)),
           J.geometry_ggx_smith(_j(a), _j(b), _j(r)))
    v = rng.standard_normal((PN, 9, 3)).astype(np.float32)
    _close(T.saturate_dot(_t(v), _t(f0)), J.saturate_dot(_j(v), _j(f0)))


def test_predict_materials_match():
    cfg_j, _ = _cfgs()
    pj, pt = _params(cfg_j)
    pts = _points(0)[0]
    with torch.no_grad():
        out_t = T.predict_materials_mc(pt, _t(pts))
    for a, b in zip(out_t, J.predict_materials_mc(pj, _j(pts))):
        _close(a, b)


@pytest.mark.parametrize("version", ["direction", "sphere_direction"])
def test_light_heads_match(version):
    cfg_j, cfg_t = _cfgs(outer_light_version=version, human_lights=True)
    pj, pt = _params(cfg_j)
    pj, pt = resolve_jax(pj), resolve_weight_norm(pt)
    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.6, 0.6, (PN, 5, 3)).astype(np.float32)
    dirs = rng.standard_normal((PN, 5, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    nrm = rng.standard_normal((PN, 5, 3)).astype(np.float32)
    human = np.broadcast_to(_points(0)[3][:, None], (PN, 5, 3, 4)).copy()
    with torch.no_grad():
        _close(T.predict_outer_lights(pt, cfg_t, _t(pts), _t(dirs)),
               J.predict_outer_lights(pj, cfg_j, _j(pts), _j(dirs)))
        _close(T.get_inner_lights(pt, cfg_t, _t(pts), _t(dirs), _t(nrm)),
               J.get_inner_lights(pj, cfg_j, _j(pts), _j(dirs), _j(nrm)))
        for a, b in zip(T.get_human_light(pt, _t(pts), _t(dirs), _t(human)),
                        J.get_human_light(pj, _j(pts), _j(dirs), _j(human))):
            _close(a, b)
        _close(T.predict_outer_lights_pts(pt, cfg_t, _t(dirs[:, 0])),
               J.predict_outer_lights_pts(pj, cfg_j, _j(dirs[:, 0])))


@pytest.mark.parametrize("is_real", [False, True])
def test_env_light_image_matches(is_real):
    cfg_j, cfg_t = _cfgs(is_real=is_real)
    pj, pt = _params(cfg_j)
    with torch.no_grad():
        _close(T.env_light_image(pt, cfg_t, 8, 16), J.env_light_image(pj, cfg_j, 8, 16))


# ---------------------------------------------------------------------------
# the whole shader, values and parameter gradients
# ---------------------------------------------------------------------------

_GRAD_KEYS = ("diffuse_light", "specular_light", "approximate_light", "human_lights")


def _shade_both(cfg_j, cfg_t, pj, pt, trace_pair, key=None):
    assert cfg_j.ide_deg == 4, "gradients are compared at ide_deg 4 (module docstring)"
    pts, view, normals, human = _points(0)
    sj, st = J.make_direction_samples(cfg_j), T.make_direction_samples(cfg_t)
    hp_j = _j(human) if cfg_j.human_lights else None
    hp_t = _t(human) if cfg_t.human_lights else None
    rots = None
    if key is not None:
        k_d, k_s = jax.random.split(key)
        rots = tuple(_t(np.asarray(jax.random.uniform(k, (PN, 1, 1)))) for k in (k_d, k_s))

    def loss_j(p):
        colors, out = J.mc_shading_apply(p, cfg_j, sj, trace_pair[0], _j(pts), _j(view),
                                         _j(normals), hp_j, key=key)
        return jnp.mean(colors ** 2) + sum(jnp.mean(out[k]) for k in _GRAD_KEYS), (colors, out)

    (lj, (colors_j, out_j)), g_j = jax.value_and_grad(loss_j, has_aux=True)(pj)
    colors_t, out_t = T.mc_shading_apply(pt, cfg_t, st, trace_pair[1], _t(pts), _t(view),
                                         _t(normals), hp_t, rots=rots)
    lt = torch.mean(colors_t ** 2) + sum(torch.mean(out_t[k]) for k in _GRAD_KEYS)
    return (colors_j, out_j, g_j, lj), (colors_t, out_t, _torch_grads(lt, pt), lt)


@pytest.mark.parametrize("human", [False, True], ids=["nohuman", "human"])
@pytest.mark.parametrize("version", ["direction", "sphere_direction"])
def test_mc_shading_apply_matches(version, human):
    cfg_j, cfg_t = _cfgs(outer_light_version=version, human_lights=human, ide_deg=4)
    pj, pt = _params(cfg_j)
    (cj, oj, gj, lj), (ct, ot, gt, lt) = _shade_both(cfg_j, cfg_t, pj, pt, (trace_j, trace_t))
    _close(ct, cj, msg="colors")
    assert set(oj) == set(ot)
    for k in oj:
        _close(ot[k], oj[k], msg=k)
    assert float(lt.detach()) == pytest.approx(float(lj), rel=1e-5)
    _grad_close(gt, gj, f"{version} human={human}")
    # the lights are traced: some directions hit the occluder, some miss
    assert float(np.abs(gt["inner_light|3|b"]).max()) > 0 and \
        float(np.abs(gt["outer_light|3|b"]).max()) > 0


@pytest.mark.parametrize("version", ["direction", "sphere_direction"])
def test_mc_shading_apply_values_at_default_ide_degree(version):
    """Forward values at ide_deg = 5, human light on."""
    cfg_j, cfg_t = _cfgs(outer_light_version=version, human_lights=True)
    pj, pt = _params(cfg_j)
    pts, view, normals, human = _points(0)
    sj, st = J.make_direction_samples(cfg_j), T.make_direction_samples(cfg_t)
    cj, oj = J.mc_shading_apply(pj, cfg_j, sj, trace_j, _j(pts), _j(view), _j(normals),
                                _j(human))
    with torch.no_grad():
        ct, ot = T.mc_shading_apply(pt, cfg_t, st, trace_t, _t(pts), _t(view), _t(normals),
                                    _t(human))
    _close(ct, cj, msg="colors")
    for k in oj:
        _close(ot[k], oj[k], msg=k)


def test_mc_shading_apply_with_azimuth_rotation_matches():
    """Training mode: the rotation draws of the JAX key go to the port."""
    cfg_j, cfg_t = _cfgs(human_lights=True, ide_deg=4)
    pj, pt = _params(cfg_j, seed=1)
    (cj, oj, gj, _), (ct, ot, gt, _) = _shade_both(cfg_j, cfg_t, pj, pt, (trace_j, trace_t),
                                                   key=jax.random.PRNGKey(11))
    _close(ct, cj, msg="colors")
    for k in oj:
        _close(ot[k], oj[k], msg=k)
    _grad_close(gt, gj, "rotated")


def test_ggx_smith_geometry_term_matches():
    cfg_j, cfg_t = _cfgs(geometry_type="ggx_smith", ide_deg=4)
    pj, pt = _params(cfg_j)
    (cj, _, gj, _), (ct, _, gt, _) = _shade_both(cfg_j, cfg_t, pj, pt, (trace_j, trace_t))
    _close(ct, cj, msg="colors")
    _grad_close(gt, gj, "ggx_smith")


# ---------------------------------------------------------------------------
# compaction: the static-capacity semantics of the JAX package
# ---------------------------------------------------------------------------


def _lights_both(cfg_j, cfg_t, hit, pn, sn, seed, human=False):
    pj, pt = _params(cfg_j, seed=seed)
    pj, pt = resolve_jax(pj), resolve_weight_norm(pt)
    rng = np.random.RandomState(seed)
    pts = np.broadcast_to((rng.randn(pn, 3) * 0.3).astype(np.float32)[:, None],
                          (pn, sn, 3)).copy()
    dirs = rng.randn(pn, sn, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    hp = None
    if human:
        hp = np.broadcast_to(np.asarray(human_poses_jax(_j(_poses(pn, seed))))[:, None],
                             (pn, sn, 3, 4)).copy()
    out_j = J.get_lights(pj, cfg_j, _mask_trace(jnp, hit), _j(pts), _j(dirs),
                         None if hp is None else _j(hp))
    out_t = T.get_lights(pt, cfg_t, _mask_trace(torch, hit), _t(pts), _t(dirs),
                         None if hp is None else _t(hp))
    return out_j, out_t, pt


COMPACT_CASES = {
    # name: (inner frac, outer frac, hit rate, human lights)
    "inner_capacity_sufficient": (0.5, 0.0, 0.2, False),
    "inner_no_hits": (0.25, 0.0, 0.0, False),
    "inner_hit_overflow": (0.25, 0.0, 1.0, False),
    "outer_capacity_sufficient": (0.0, 0.6, 0.6, False),
    "outer_no_misses": (0.0, 0.1, 1.0, False),
    "outer_miss_overflow": (0.0, 0.25, 0.0, False),
    "outer_human_lights": (0.0, 0.6, 0.6, True),
    "both_compacted": (0.5, 0.75, 0.4, True),
}


@pytest.mark.parametrize("case", list(COMPACT_CASES))
def test_compacted_lights_match_jax(case):
    """Same K = ceil-to-128 capacity, stable order, overflow hits keep the
    miss light, overflow misses keep zero: every output of get_lights."""
    inner, outer, rate, human = COMPACT_CASES[case]
    pn, sn = 8, 64
    cfg_j, cfg_t = _cfgs(inner_compact_frac=inner, outer_compact_frac=outer,
                         human_lights=human)
    hit = np.random.RandomState(5).rand(pn * sn) < rate
    out_j, out_t, _ = _lights_both(cfg_j, cfg_t, hit, pn, sn, seed=2, human=human)
    for name, a, b in zip(("lights", "human", "inters", "normals", "hit"), out_t, out_j):
        if name == "hit":
            assert (a.numpy() == np.asarray(b)).all()
        else:
            _close(a, b, msg=f"{case} {name}")


def test_hit_overflow_keeps_miss_light():
    """512 hits into 128 slots: the first 128 (stable order) get the inner
    light, the rest the outer light."""
    pn, sn = 8, 64
    cfg_j, cfg_t = _cfgs(inner_compact_frac=0.25)
    _, cfg_full = _cfgs()
    hit = np.ones(pn * sn, bool)
    _, out_t, pt = _lights_both(cfg_j, cfg_t, hit, pn, sn, seed=2)
    rng = np.random.RandomState(2)
    pts = np.broadcast_to((rng.randn(pn, 3) * 0.3).astype(np.float32)[:, None],
                          (pn, sn, 3)).copy()
    dirs = rng.randn(pn, sn, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    with torch.no_grad():
        full = T.get_lights(pt, cfg_full, _mask_trace(torch, hit), _t(pts), _t(dirs), None)[0]
        outer = T.predict_outer_lights(pt, cfg_t, _t(pts), _t(dirs))
    comp = out_t[0].detach().reshape(-1, 3)
    torch.testing.assert_close(comp[:128], full.reshape(-1, 3)[:128], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(comp[128:], outer.reshape(-1, 3)[128:], rtol=1e-5, atol=1e-5)


def test_miss_overflow_keeps_zero_light():
    pn, sn = 8, 64
    cfg_j, cfg_t = _cfgs(outer_compact_frac=0.25)
    hit = np.zeros(pn * sn, bool)
    _, out_t, _ = _lights_both(cfg_j, cfg_t, hit, pn, sn, seed=2)
    lights = out_t[0].detach().reshape(-1, 3)
    assert (lights[:128] > 0).all() and (lights[128:] == 0).all()


def test_compaction_indices():
    mask = torch.tensor([False, True, True, False, True] + [False] * 251)
    src, to = T._compaction(mask, 0.5)      # n = 256 -> K = 128
    assert src.shape == (128,) and src[:3].tolist() == [1, 2, 4]
    assert to[:3].tolist() == [1, 2, 4] and (to[3:] == 256).all()


@pytest.mark.parametrize("which", ["inner", "outer"])
def test_gradients_flow_through_compaction(which):
    """Parameter gradients of the whole shader with compaction on, against
    nero_tpu's: the gather feeds the light MLPs exactly as there."""
    kw = {"inner_compact_frac": 0.5} if which == "inner" else {"outer_compact_frac": 0.75}
    cfg_j, cfg_t = _cfgs(ide_deg=4, **kw)
    pj, pt = _params(cfg_j, seed=3)
    (cj, _, gj, _), (ct, _, gt, _) = _shade_both(cfg_j, cfg_t, pj, pt, (trace_j, trace_t))
    _close(ct, cj, msg="colors")
    _grad_close(gt, gj, f"compacted {which}")
    assert max(float(np.abs(v).max()) for k, v in gt.items()
               if k.startswith(f"{which}_light")) > 0


# ---------------------------------------------------------------------------
# regularisers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("change_type", ["gaussian", "constant"])
@pytest.mark.parametrize("step", [0, 5000])
def test_material_regularization_matches(change_type, step):
    """The draws of the JAX key (uniform angle, normal step) go to the port:
    value and parameter gradients of the whole regulariser."""
    cfg_j, cfg_t = _cfgs(change_type=change_type)
    pj, pt = _params(cfg_j)
    pts, _, normals, _ = _points(4)
    key = jax.random.PRNGKey(9)
    k_ang, k_eps = jax.random.split(key)
    draws = (_t(np.asarray(jax.random.uniform(k_ang, (PN, 1)))),
             _t(np.asarray(jax.random.normal(k_eps, (PN, 1)))))

    def reg_j(p):
        m, r, a = J.predict_materials_mc(p, _j(pts))
        return jnp.mean(J.material_regularization(p, cfg_j, key, _j(pts), _j(normals), m, r,
                                                  a, step))

    val_j, g_j = jax.value_and_grad(reg_j)(pj)
    m, r, a = T.predict_materials_mc(pt, _t(pts))
    reg_t = T.material_regularization(pt, cfg_t, None, _t(pts), _t(normals), m, r, a, step,
                                      draws=draws)
    assert reg_t.shape == (PN,)
    assert float(reg_t.mean().detach()) == pytest.approx(float(val_j), rel=1e-4, abs=1e-7)
    _grad_close(_torch_grads(reg_t.mean(), pt), g_j, "material_regularization")


def test_material_regularization_min_max_part_is_exact():
    """Without the drawn smoothness term the regulariser is deterministic."""
    cfg_j, cfg_t = _cfgs(reg_change=False)
    rough = np.asarray([[0.0005], [0.5], [0.99]], np.float32)
    metal = np.asarray([[0.01], [0.5], [0.995]], np.float32)
    alb = np.zeros((3, 3), np.float32)
    z = np.zeros((3, 3), np.float32)
    for step in (0, 1999, 2000):
        ref = J.material_regularization(None, cfg_j, None, _j(z), _j(z), _j(metal), _j(rough),
                                        _j(alb), step)
        out = T.material_regularization(None, cfg_t, None, _t(z), _t(z), _t(metal), _t(rough),
                                        _t(alb), step)
        _close(out, ref, atol=1e-7)
    assert float(out.sum()) == 0.0


def test_regularization_draws_from_generator():
    cfg_j, cfg_t = _cfgs()
    _, pt = _params(cfg_j)
    pts, _, normals, _ = _points(4)
    with torch.no_grad():
        m, r, a = T.predict_materials_mc(pt, _t(pts))
        regs = [T.material_regularization(pt, cfg_t, torch.Generator().manual_seed(s), _t(pts),
                                          _t(normals), m, r, a, 5000) for s in (0, 0, 1)]
    assert torch.equal(regs[0], regs[1]) and not torch.equal(regs[0], regs[2])
    assert (regs[0] >= 0).all() and torch.isfinite(regs[0]).all()


def test_fused_lights_raise():
    """`fused_lights=True` no longer raises: get_lights goes through
    ops/lights.py (its plain version for these CPU tensors) and gives the
    lights of the unfused path; a configuration the kernel does not take
    (outer compaction on) raises a RuntimeWarning, once, and takes the
    unfused path."""
    from nero_tpu_torch.ops import lights as L
    cfg_j, cfg_t = _cfgs()
    hit = np.random.RandomState(5).rand(8 * 64) < 0.4
    out_j, out_ref, _ = _lights_both(cfg_j, cfg_t, hit, 8, 64, seed=2)
    before = dict(L.launches)
    _, out_fused, _ = _lights_both(cfg_j, cfg_t._replace(fused_lights=True), hit, 8, 64, seed=2)
    assert L.launches == before          # CPU tensors: the plain version, no launch
    for a, b, c in zip(out_fused[:2], out_ref[:2], out_j[:2]):
        _close(a, b.detach())
        _close(a, c)
    cfg_bad = cfg_t._replace(fused_lights=True, outer_compact_frac=0.6)
    with pytest.warns(RuntimeWarning, match="unfused light path"):
        assert not T.fused_lights_active(cfg_bad)
    assert T.fused_lights_active(cfg_t._replace(fused_lights=True))
    assert not T.fused_lights_active(cfg_t)


def test_config_from_dict_ignores_unknown_keys():
    cfg = T.mc_config_from_dict({"diffuse_sample_num": 8, "unknown": 1, "bf16_hidden": True})
    assert cfg.diffuse_sample_num == 8 and cfg.specular_sample_num == 256
    assert T.MCShadingConfig._fields == J.MCShadingConfig._fields
