"""Stage-I renderer and train step of the port against nero_tpu on the CPU,
f32, on the tiny config of tests/test_shape_e2e.py: the same weights (bridged
from the JAX init) and the same rays (made with numpy) go through both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nero_tpu.ops.fg_lut import get_fg_lut as jax_fg_lut
from nero_tpu.ops.mlp import resolve_weight_norm as jax_resolve
from nero_tpu.render import shape as J
from nero_tpu.train.losses import compute_losses as jax_compute_losses, total_loss as jax_total
from nero_tpu_torch.core.convert import from_numpy_tree, tree_items
from nero_tpu_torch.models.shape import NeROShapeModel
from nero_tpu_torch.ops.fg_lut import get_fg_lut
from nero_tpu_torch.ops.mlp import resolve_weight_norm
from nero_tpu_torch.render import shape as T

# one intra-op thread: the suite runs several worker processes side by side
torch.set_num_threads(1)

TINY_CFG = {
    "name": "test_tiny", "network": "shape", "database_name": "proc/sphere/32_6",
    "n_samples": 16, "n_importance": 8, "up_sample_steps": 2, "n_bg_samples": 4,
    "train_ray_num": 32, "test_ray_num": 64, "occ_loss_step": 5, "occ_loss_max_pn": 64,
    "anneal_end": 100, "test_downsample_ratio": True, "downsample_ratio": 0.5,
    "loss": ["nerf_render", "eikonal", "std", "init_sdf_reg", "occ"],
    "eikonal_weight": 0.1, "key_metric_name": "psnr", "perturb": 0.0,
}
R = 32


def _rays(seed=0):
    """Rays from a sphere of radius 2.5 aimed near the origin, with near/far."""
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((R, 3))
    o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + rng.uniform(-0.4, 0.4, (R, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    mid = -np.sum(o * d, -1, keepdims=True)
    near, far = np.maximum(mid - 1.0, 1e-3), mid + 1.0
    rgb = rng.uniform(0, 1, (R, 3))
    return {k: v.astype(np.float32) for k, v in
            dict(rays_o=o, rays_d=d, near=near, far=far, rgb=rgb).items()}


@pytest.fixture(scope="module")
def setup():
    scfg_j = J.shape_config_from_dict(dict(TINY_CFG))
    params_j = jax.tree_util.tree_map(
        np.asarray, J.init_shape_params(jax.random.PRNGKey(0), scfg_j))
    scfg_t = T.shape_config_from_dict(dict(TINY_CFG))
    return scfg_j, scfg_t, params_j, _rays()


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_sample_z_vals(setup):
    scfg_j, scfg_t, params_j, rays = setup
    zi_j, zo_j = J.sample_z_vals(jax.tree_util.tree_map(jnp.asarray, params_j), scfg_j,
                                 *[_j(rays[k]) for k in ("rays_o", "rays_d", "near", "far")],
                                 key=None, perturb=0.0)
    zi_t, zo_t = T.sample_z_vals(from_numpy_tree(params_j), scfg_t,
                                 *[_t(rays[k]) for k in ("rays_o", "rays_d", "near", "far")],
                                 gen=None, perturb=0.0)
    assert zi_t.shape == (R, scfg_t.n_inner) and zo_t.shape == (R, scfg_t.n_bg_samples)
    # importance samples: float noise in the sdf is amplified by the up-sample
    # sigmoid (inv_s up to 128); positions lie in [1.5, 3.5]
    np.testing.assert_allclose(zi_t.numpy(), np.asarray(zi_j), atol=1e-3)
    np.testing.assert_allclose(zo_t.numpy(), np.asarray(zo_j), atol=1e-6)


def test_render_core(setup):
    scfg_j, scfg_t, params_j, rays = setup
    pj = jax_resolve(jax.tree_util.tree_map(jnp.asarray, params_j))
    zi, zo = J.sample_z_vals(pj, scfg_j, *[_j(rays[k]) for k in
                                            ("rays_o", "rays_d", "near", "far")], perturb=0.0)
    z_full = np.asarray(jnp.concatenate([zi, zo], -1))
    out_j = J.render_core(pj, scfg_j, _j(jax_fg_lut()), _j(rays["rays_o"]), _j(rays["rays_d"]),
                          _j(z_full), jnp.zeros((R, 3, 4)), 0.5, 2, is_train=True,
                          key=jax.random.PRNGKey(0))
    with torch.no_grad():
        out_t = T.render_core(resolve_weight_norm(from_numpy_tree(params_j)), scfg_t,
                              _t(get_fg_lut()), _t(rays["rays_o"]), _t(rays["rays_d"]),
                              _t(z_full), (0.5, 0.5), 2, is_train=True)
    assert set(out_t) == set(out_j)
    for k in out_j:
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), atol=1e-5,
                                   rtol=1e-4, err_msg=k)


def test_compute_occ_loss(setup):
    """occ_loss_max_pn >= R*S selects every masked candidate, so the random
    scores (different generators in the two packages) drop out."""
    scfg_j, scfg_t, params_j, _ = setup
    S = 24
    rng = np.random.default_rng(5)
    pts = rng.uniform(-0.55, 0.55, (R, S, 3)).astype(np.float32)
    refl = rng.standard_normal((R, S, 3)).astype(np.float32)
    refl /= np.linalg.norm(refl, axis=-1, keepdims=True)
    occ = rng.uniform(0, 1, (R, S)).astype(np.float32)
    sdf = rng.uniform(-0.02, 0.02, (R, S)).astype(np.float32)
    grads = rng.standard_normal((R, S, 3)).astype(np.float32)
    dirs = rng.standard_normal((R, S, 3)).astype(np.float32)
    scfg_j = scfg_j._replace(occ_loss_max_pn=R * S)
    scfg_t = scfg_t._replace(occ_loss_max_pn=R * S)
    pj = jax_resolve(jax.tree_util.tree_map(jnp.asarray, params_j))
    ref = J.compute_occ_loss(pj, scfg_j, jax.random.PRNGKey(1), _j(pts), _j(refl), _j(occ),
                             _j(sdf), _j(grads), _j(dirs), 10)
    out = T.compute_occ_loss(resolve_weight_norm(from_numpy_tree(params_j)), scfg_t,
                             torch.Generator().manual_seed(1), _t(pts), _t(refl), _t(occ),
                             _t(sdf), _t(grads), _t(dirs))
    assert float(ref) > 0.0
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-4, atol=1e-6)


def test_train_step_loss_and_grads(setup):
    """One step's loss and every {v,g,b} gradient against jax.value_and_grad
    of nero_tpu's render + losses (step < occ_loss_step; the JAX key feeds
    only the inactive occlusion branch). Gradients normalised by each leaf's
    max, or by 1e-2 of the largest gradient of the step where the leaf is
    smaller than that: 1e-3 (f32 double backprop through the whole render,
    summed in a different order by the two frameworks; leaves such as the
    inner-light head at init carry gradients of ~1e-6, where that order
    alone moves them by ~1e-7)."""
    scfg_j, _, params_j, rays = setup
    step = 3
    cfg = {**dict(TINY_CFG), "rgb_loss": "charbonier"}

    def loss_j(p):
        out = J.render(p, scfg_j, _j(jax_fg_lut()), _j(rays["rays_o"]), _j(rays["rays_d"]),
                       _j(rays["near"]), _j(rays["far"]), jnp.zeros((R, 3, 4)), step,
                       key=jax.random.PRNGKey(0), is_train=True, perturb_overwrite=0.0)
        out["loss_rgb"] = J.compute_rgb_loss(out["ray_rgb"], _j(rays["rgb"]), "charbonier")
        return jax_total(jax_compute_losses(cfg["loss"], out, None, step, cfg))

    val_j, g_j = jax.jit(jax.value_and_grad(loss_j))(
        jax.tree_util.tree_map(jnp.asarray, params_j))

    model = NeROShapeModel(cfg, training=False, device="cpu")
    model.params = from_numpy_tree(params_j)
    loss_t, _ = model.loss_fn(model.params, {k: _t(v) for k, v in rays.items()}, step, gen=None)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(val_j), rtol=1e-4)
    grads_j = list(tree_items(jax.tree_util.tree_map(np.asarray, g_j)))
    floor = 1e-2 * max(np.abs(a).max() for _, a in grads_j)
    for k, a in grads_j:
        b = dict(tree_items(model.params))[k].grad
        b = np.zeros_like(a) if b is None else b.numpy()
        scale = max(np.abs(a).max(), floor)
        np.testing.assert_allclose(b / scale, a / scale, atol=1e-3, err_msg=k)
