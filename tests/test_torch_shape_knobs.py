"""The Stage-I renderer's switches `bg_on_inner`, `shade_top_k` and
`remat_shader` in the port against nero_tpu/render/shape.py on the CPU, f32,
tiny config: the same weights (bridged from the JAX init) and the same rays
(made with numpy) go through both."""
import warnings

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

torch.set_num_threads(1)

R = 32
OCC_STEP = 5
TINY_CFG = {
    "name": "test_tiny", "network": "shape", "database_name": "proc/sphere/32_6",
    "n_samples": 16, "n_importance": 8, "up_sample_steps": 2, "n_bg_samples": 4,
    "train_ray_num": R, "test_ray_num": 64, "occ_loss_step": OCC_STEP,
    # every masked candidate is selected, so the random scores (different
    # generators in the two packages) drop out of the occlusion loss
    "occ_loss_max_pn": R * 24,
    "anneal_end": 100, "test_downsample_ratio": True, "downsample_ratio": 0.5,
    "loss": ["nerf_render", "eikonal", "std", "init_sdf_reg", "occ"],
    "eikonal_weight": 0.1, "key_metric_name": "psnr", "perturb": 0.0,
}


def _rays(seed=0):
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


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def setup():
    scfg_j = J.shape_config_from_dict(dict(TINY_CFG))
    params_j = jax.tree_util.tree_map(
        np.asarray, J.init_shape_params(jax.random.PRNGKey(0), scfg_j))
    rays = _rays()
    pj = jax_resolve(jax.tree_util.tree_map(jnp.asarray, params_j))
    zi, zo = J.sample_z_vals(pj, scfg_j, *[_j(rays[k]) for k in
                                            ("rays_o", "rays_d", "near", "far")], perturb=0.0)
    z_full = np.asarray(jnp.concatenate([zi, zo], -1))
    return params_j, rays, z_full


def _render_core_both(setup, over: dict, step: int, is_train: bool = True, params_j=None,
                      human_poses=None):
    """render_core of both packages on the fixture's rays and z values;
    `params_j` and `human_poses` [R, 3, 4] for a shader with the human light."""
    default_params, rays, z_full = setup
    params_j = default_params if params_j is None else params_j
    cfg = {**TINY_CFG, **over}
    scfg_j, scfg_t = J.shape_config_from_dict(dict(cfg)), T.shape_config_from_dict(dict(cfg))
    pj = jax_resolve(jax.tree_util.tree_map(jnp.asarray, params_j))
    hp_j = jnp.zeros((R, 3, 4)) if human_poses is None else _j(human_poses)
    out_j = J.render_core(pj, scfg_j, _j(jax_fg_lut()), _j(rays["rays_o"]), _j(rays["rays_d"]),
                          _j(z_full), hp_j, 0.5, step, is_train=is_train,
                          key=jax.random.PRNGKey(0))
    with torch.no_grad():
        out_t = T.render_core(resolve_weight_norm(from_numpy_tree(params_j)), scfg_t,
                              _t(get_fg_lut()), _t(rays["rays_o"]), _t(rays["rays_d"]),
                              _t(z_full), (0.5, 0.5), step, is_train=is_train,
                              gen=torch.Generator().manual_seed(0),
                              human_poses=None if human_poses is None else _t(human_poses))
    return out_j, out_t


def _assert_outputs_close(out_j, out_t):
    assert set(out_t) == set(out_j)
    for k in out_j:
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), atol=1e-5,
                                   rtol=1e-4, err_msg=k)


def test_config_fields_reach_the_port():
    scfg = T.shape_config_from_dict({"bg_on_inner": True, "shade_top_k": 32,
                                     "remat_shader": True, "use_fused_sdf": True,
                                     "shader_config": {"fused_heads": True,
                                                       "fused_shader": False}})
    assert scfg.bg_on_inner and scfg.shade_top_k == 32 and scfg.remat_shader
    assert scfg.use_fused_sdf and scfg.shader.fused_heads and scfg.shader.fused_shader is False
    default = T.shape_config_from_dict({})
    assert not default.bg_on_inner and default.shade_top_k == 0 and not default.remat_shader
    assert not default.use_fused_sdf and default.shader.fused_shader is None


@pytest.mark.parametrize("key,value,device,resolved", [
    ("sdf_grad_mode", None, "cpu", "rev"), ("sdf_grad_mode", None, "cuda", "fused"),
    ("sdf_grad_mode", "fused", "cuda", "fused"), ("sdf_grad_mode", "rev", "cpu", "rev"),
    ("sdf_grad_mode", "fused", "cpu", "rev"), ("sdf_grad_mode", "rev", "cuda", "rev"),
    ("sdf_grad_mode", "fwd", "cpu", "fwd"), ("sdf_grad_mode", "fwd", "cuda", "fwd"),
    ("bf16_hidden", None, "cuda", True), ("bf16_hidden", True, "cuda", True),
    ("bf16_hidden", False, "cpu", False), ("bf16_hidden", True, "cpu", True),
    ("bf16_hidden", None, "cpu", False), ("bf16_hidden", False, "cuda", False),
    ("sdf_grad_mode", "bwd", "cpu", ValueError), ("bf16_hidden", "on", "cuda", ValueError),
])
def test_precision_keys_are_honoured_or_refused(key, value, device, resolved):
    """nero_tpu switches precision on these keys and the port honours every
    value, resolved by nero_tpu's rules with CUDA in the TPU's place
    (`fused` where the kernel cannot run warns and takes `rev`); a value
    outside the enumerations is refused with ValueError."""
    cfg = {key: value}
    if resolved is ValueError:
        with pytest.raises(ValueError, match=key):
            T.shape_config_from_dict(cfg)
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scfg = T.shape_config_from_dict(cfg).resolved(device)
    assert getattr(scfg, key) == resolved


def test_shape_model_refuses_an_unported_precision_key():
    """The model resolves its switches at construction: `fwd` is honoured on
    the CPU, an unknown value refused."""
    model = NeROShapeModel({**TINY_CFG, "sdf_grad_mode": "fwd"}, training=False, device="cpu")
    assert model.scfg.sdf_grad_mode == "fwd" and model.scfg.bf16_hidden is False
    with pytest.raises(ValueError, match="sdf_grad_mode"):
        NeROShapeModel({**TINY_CFG, "sdf_grad_mode": "forward"}, training=False, device="cpu")


@pytest.mark.parametrize("step", [2, OCC_STEP + 1], ids=["before_occ", "occ_phase"])
def test_bg_on_inner(setup, step):
    """The background on the full lattice, selected by the inner mask."""
    out_j, out_t = _render_core_both(setup, {"bg_on_inner": True}, step)
    _assert_outputs_close(out_j, out_t)
    # and it is a different render from the outer-samples-only default where
    # inner samples leave the unit sphere
    _, out_default = _render_core_both(setup, {}, step)
    assert not torch.equal(out_t["ray_rgb"], out_default["ray_rgb"])


@pytest.mark.parametrize("k", [8, 20])
def test_shade_top_k_before_occ_step_is_the_full_lattice(setup, k):
    out_j, out_t = _render_core_both(setup, {"shade_top_k": k}, OCC_STEP - 1)
    _assert_outputs_close(out_j, out_t)
    _, out_full = _render_core_both(setup, {}, OCC_STEP - 1)
    for key in out_full:
        assert torch.equal(out_t[key], out_full[key]), key


@pytest.mark.parametrize("k", [8, 20])
def test_shade_top_k_in_the_occ_phase(setup, k):
    """From occ_loss_step on only the k heaviest samples of a ray are shaded,
    and the occlusion loss draws its candidates from them (k = 20 of 24
    reaches into the zero-weight samples: see `test_top_k_ties`)."""
    out_j, out_t = _render_core_both(setup, {"shade_top_k": k}, OCC_STEP)
    _assert_outputs_close(out_j, out_t)
    assert float(out_t["loss_occ"]) > 0.0
    _, out_full = _render_core_both(setup, {}, OCC_STEP)
    # a different render from the full lattice, but close: the dropped
    # samples carry little weight
    d = (out_t["ray_rgb"] - out_full["ray_rgb"]).abs().max().item()
    assert 0.0 < d < (0.2 if k == 8 else 0.05)


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "validation"])
def test_shade_top_k_with_the_human_light(setup, is_train):
    """The real-capture shader under shade_top_k: the selection carries each
    sample's human pose along (random camera frames, one per ray)."""
    over = {"shade_top_k": 8, "shader_config": {"human_light": True, "sphere_direction": True}}
    scfg_j = J.shape_config_from_dict({**TINY_CFG, **over})
    params_j = jax.tree_util.tree_map(
        np.asarray, J.init_shape_params(jax.random.PRNGKey(0), scfg_j))
    rng = np.random.default_rng(4)
    q, _ = np.linalg.qr(rng.standard_normal((R, 3, 3)))
    hp = np.concatenate([q, rng.uniform(-0.5, 0.5, (R, 3, 1))], -1).astype(np.float32)
    out_j, out_t = _render_core_both(setup, over, OCC_STEP + 1, is_train, params_j, hp)
    _assert_outputs_close(out_j, out_t)
    if not is_train:
        assert float(out_t["human_light"].abs().max()) > 0.0


def test_shade_top_k_validation_is_the_full_lattice(setup):
    out_j, out_t = _render_core_both(setup, {"shade_top_k": 8}, OCC_STEP + 3, is_train=False)
    _assert_outputs_close(out_j, out_t)
    _, out_full = _render_core_both(setup, {}, OCC_STEP + 3, is_train=False)
    for key in out_full:
        assert torch.equal(out_t[key], out_full[key]), key


def test_top_k_ties():
    """jax.lax.top_k gives the lower index first among equal entries;
    torch.topk promises nothing. The port's choice is a stable descending
    sort, which keeps equal entries in index order: the same indices as JAX
    on rows full of ties (the zero weights behind a surface)."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (16, 24)).astype(np.float32)
    x[:, 10:] = 0.0                      # 14 tied zeros per row
    x[3, :] = 0.5                        # a row of all ties
    x[5, [2, 7, 9]] = 0.75               # ties among the leaders
    for k in (4, 12, 20):
        vals_j, idx_j = jax.lax.top_k(jnp.asarray(x), k)
        vals_t, idx_t = T.top_k_lowest_index_first(torch.from_numpy(x), k)
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
        np.testing.assert_array_equal(vals_t.numpy(), np.asarray(vals_j))


def test_shade_top_k_train_step_loss_and_grads(setup):
    """One step in the occ phase with shade_top_k: loss and every {v,g,b}
    gradient against jax.value_and_grad of nero_tpu's render + losses (the
    selection's gather carries gradients to feats, normals and weights).
    Normalised as tests/test_torch_shape.py::test_train_step_loss_and_grads."""
    params_j, rays, _ = setup
    step = OCC_STEP + 1
    cfg = {**TINY_CFG, "shade_top_k": 8}
    scfg_j = J.shape_config_from_dict(dict(cfg))

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
    loss_t, log = model.loss_fn(model.params, {k: _t(v) for k, v in rays.items()}, step,
                                gen=torch.Generator().manual_seed(0))
    loss_t.backward()
    assert float(log["loss_occ"].detach()) > 0.0
    np.testing.assert_allclose(loss_t.item(), float(val_j), rtol=1e-4)
    grads_j = list(tree_items(jax.tree_util.tree_map(np.asarray, g_j)))
    floor = 1e-2 * max(np.abs(a).max() for _, a in grads_j)
    for k, a in grads_j:
        b = dict(tree_items(model.params))[k].grad
        b = np.zeros_like(a) if b is None else b.numpy()
        scale = max(np.abs(a).max(), floor)
        np.testing.assert_allclose(b / scale, a / scale, atol=1e-3, err_msg=k)


@pytest.mark.parametrize("over", [{}, {"shade_top_k": 8},
                                  {"shader_config": {"human_light": True}},
                                  {"shade_top_k": 8, "shader_config": {"human_light": True}}],
                         ids=["default", "top_k", "human", "human_top_k"])
def test_remat_shader_gradients_equal(over):
    """torch.utils.checkpoint around the shader: the same loss and the same
    gradients as keeping its activations (the recomputation repeats the same
    f32 operations), in training; validation does not checkpoint."""
    rays = {k: _t(v) for k, v in _rays(1).items()}
    rays["human_poses"] = torch.eye(3, 4).expand(R, 3, 4).clone()
    grads = {}
    for remat in (False, True):
        model = NeROShapeModel({**TINY_CFG, **over, "remat_shader": remat}, training=False,
                               device="cpu")
        assert bool(model.scfg.remat_shader) is remat
        loss, _ = model.loss_fn(model.params, rays, OCC_STEP + 1,
                                gen=torch.Generator().manual_seed(0))
        loss.backward()
        grads[remat] = (loss.item(), {k: v.grad for k, v in tree_items(model.params)})
    assert grads[True][0] == grads[False][0]
    for k, g in grads[False][1].items():
        g2 = grads[True][1][k]
        assert (g is None) == (g2 is None), k
        if g is not None:
            torch.testing.assert_close(g2, g, atol=1e-7, rtol=1e-5, msg=k)


def test_remat_shader_matches_jax_loss(setup):
    """nero_tpu's jax.checkpoint'ed shader and the port's give the same
    training outputs."""
    out_j, out_t = _render_core_both(setup, {"remat_shader": True}, 2)
    _assert_outputs_close(out_j, out_t)


# ---------------------------------------------------------------------------
# Stage I's kernel gates are rules about the configuration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("knob,value,taken", [("ide_deg", 6, 4), ("light_pos_freq", 129, 6),
                                              ("feats_dim", 128, None)])
def test_shader_kernel_gate_routes_to_the_per_head_path(knob, value, taken, monkeypatch):
    """A shader the whole-shader kernel does not take (ops/shader.py::
    supported: nero_tpu's rule, 256 feats and ide_deg <= 5, and the port's
    own light_pos_freq <= 128) resolves to the per-head path, as nero_tpu's
    does (fields/app_shading.py:227-237): silently when `fused_shader` is
    unset, with a warning when it was asked for; app_shading_apply then
    never calls the kernel's wrapper. The other encodings (ide_deg 4,
    light_pos_freq 6) take the kernel, unset or asked for, without a word.
    light_pos_freq 129 is past the limit (its top octave's frequency is no
    finite f32), so its colour is NaN on either path.
    ide_deg 6 has no IDE in either package: its shader cannot be built."""
    from nero_tpu_torch.fields import app_shading as A
    from nero_tpu_torch.ops import shader as S

    cfg = A.AppShadingConfig(**{knob: value})
    assert not S.supported(cfg) and S.supported(A.AppShadingConfig())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not A.fused_shader_active(cfg)
        assert A.fused_shader_active(A.AppShadingConfig())
        assert A.fused_shader_active(A.AppShadingConfig(fused_shader=True))
        assert not A.fused_shader_active(cfg._replace(fused_shader=False))
        if taken is not None:
            other = A.AppShadingConfig(**{knob: taken})
            assert S.supported(other) and A.fused_shader_active(other)
            assert A.fused_shader_active(other._replace(fused_shader=True))
    with pytest.warns(RuntimeWarning, match=f"{knob}={value}.*per-head path"):
        assert not A.fused_shader_active(cfg._replace(fused_shader=True))
    if knob == "ide_deg":
        with pytest.raises(ValueError, match="deg_view > 5"):
            A.init_app_shading(torch.Generator().manual_seed(0), cfg)
        return
    params = A.init_app_shading(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    x = lambda w: torch.from_numpy(rng.standard_normal((5, w)).astype(np.float32))
    monkeypatch.setattr(A, "shader_raw", None)  # a call would raise
    color, _ = A.app_shading_apply(params, cfg, torch.from_numpy(get_fg_lut()), x(3), x(3),
                                   x(3), x(cfg.feats_dim))
    assert color.shape == (5, 3)
    if knob == "light_pos_freq":
        # past octave 127 the PE's frequency 2^i is inf in f32, in nero_tpu
        # too: the light heads' input and so the colour are NaN
        assert torch.isnan(color).all()
    else:
        assert torch.isfinite(color).all()


def test_fused_sdf_gate_drops_the_switch():
    """`use_fused_sdf` with an SDF the value-only kernel does not take is
    dropped with a warning, as nero_tpu drops it (render/shape.py:179-180);
    with the default SDF it stays."""
    with pytest.warns(RuntimeWarning, match="sdf_n_layers=6"):
        scfg = T.shape_config_from_dict({"use_fused_sdf": True, "sdf_n_layers": 6})
    assert not scfg.use_fused_sdf and scfg.sdf_n_layers == 6
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert T.shape_config_from_dict({"use_fused_sdf": True}).use_fused_sdf
        assert not T.shape_config_from_dict({"sdf_freq": 4}).use_fused_sdf
        # another multires (1-20) and d_out keep the switch: the value-only
        # kernel takes them, as nero_tpu's does
        assert T.shape_config_from_dict({"use_fused_sdf": True, "sdf_freq": 4}).use_fused_sdf
        assert T.shape_config_from_dict({"use_fused_sdf": True, "sdf_d_out": 129}).use_fused_sdf


@pytest.mark.parametrize("over", [{"sdf_n_layers": 6}, {"sdf_freq": 21}, {"sdf_d_out": 129}])
def test_sdf_topology_gate(over):
    """An SDF that the SDF-with-gradient kernel does not take resolves to the
    plain `rev` gradient on CUDA too, as nero_tpu resolves it on its TPU
    (render/shape.py:142-149; multires 21 is past its PE_PAD of 128); `fused`
    asked for it warns, naming the topology, and takes `rev`; the default SDF
    and another multires within 1-20 (4) take the kernel on CUDA."""
    scfg = T.shape_config_from_dict(over)
    key, value = next(iter(over.items()))
    assert scfg.resolved("cuda").sdf_grad_mode == "rev"
    assert scfg.resolved("cpu").sdf_grad_mode == "rev"
    with pytest.warns(RuntimeWarning, match=f"{key}={value}.*taking 'rev'"):
        assert scfg._replace(sdf_grad_mode="fused").resolved("cuda").sdf_grad_mode == "rev"
    assert T.shape_config_from_dict({}).resolved("cuda").sdf_grad_mode == "fused"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m4 = T.shape_config_from_dict({"sdf_freq": 4})
        assert m4.resolved("cuda").sdf_grad_mode == "fused"
        assert m4._replace(sdf_grad_mode="fused").resolved("cuda").sdf_grad_mode == "fused"


@pytest.mark.parametrize("value,honoured", [(None, True), ("highest", True),
                                            ("default", True), ("high", True),
                                            ("medium", False), ("bf16", False)])
def test_matmul_precision_is_honoured_or_refused(value, honoured, tmp_path):
    """nero_tpu sets JAX's matmul precision from `matmul_precision`
    (train/trainer.py:42-45,62): the port honours each of its names (default
    "default"; on the CPU every name computes in f32) and refuses another
    name with ValueError before it writes anything."""
    from nero_tpu_torch.train.trainer import Trainer

    cfg = {"name": "mp", "model_root": str(tmp_path), "network": "shape"}
    if value is not None:
        cfg["matmul_precision"] = value
    if honoured:
        trainer = Trainer(cfg, device="cpu")
        assert trainer.cfg["matmul_precision"] == (value or "default")
        assert trainer.product_mode == "f32"
    else:
        with pytest.raises(ValueError, match="matmul_precision"):
            Trainer(cfg, device="cpu")
        assert not (tmp_path / "mp").exists()
