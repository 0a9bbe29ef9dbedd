"""The weight bridge: a nero_tpu Stage-I init round-trips through the port's
parameters, and port and JAX give the same SDF forward on it (f32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nero_tpu.fields.sdf import sdf_apply as sdf_apply_jax
from nero_tpu.render.shape import init_shape_params, shape_config_from_dict
from nero_tpu_torch.core.convert import (from_numpy_tree, to_numpy_tree, tree_items,
                                         tree_leaves)
from nero_tpu_torch.fields.sdf import SDFConfig, sdf_apply


@pytest.fixture(scope="module")
def jax_params():
    scfg = shape_config_from_dict({})
    params = init_shape_params(jax.random.PRNGKey(0), scfg)
    return scfg, jax.tree_util.tree_map(np.asarray, params)


def test_round_trip_exact(jax_params):
    _, pj = jax_params
    pt = from_numpy_tree(pj)
    back = to_numpy_tree(pt)
    items_j, items_b = list(tree_items(pj)), list(tree_items(back))
    assert [k for k, _ in items_j] == [k for k, _ in items_b]
    for (k, a), (_, b) in zip(items_j, items_b):
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_leaf_order_matches_jax(jax_params):
    _, pj = jax_params
    leaves_j = jax.tree_util.tree_leaves(pj)
    leaves_t = tree_leaves(from_numpy_tree(pj))
    assert len(leaves_j) == len(leaves_t)
    for a, b in zip(leaves_j, leaves_t):
        np.testing.assert_array_equal(a, b.detach().numpy())


def test_weight_norm_leaves_kept(jax_params):
    _, pj = jax_params
    pt = from_numpy_tree(pj)
    for layer in pt["sdf"]:
        assert set(layer) == {"v", "g", "b"}
        assert layer["v"].requires_grad and layer["v"].shape[0] >= layer["v"].shape[1] - 257


def test_sdf_forward_matches(jax_params):
    scfg, pj = jax_params
    x = np.random.default_rng(0).uniform(-0.8, 0.8, (512, 3)).astype(np.float32)
    ref = np.asarray(sdf_apply_jax(jax.tree_util.tree_map(jnp.asarray, pj["sdf"]),
                                   jnp.asarray(x), scfg.sdf_cfg))
    with torch.no_grad():
        out = sdf_apply(from_numpy_tree(pj["sdf"]), torch.from_numpy(x), SDFConfig()).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_bridge_carries_the_human_head_and_the_wide_outer_light():
    """The real-capture shader: a seventh head (`human_light`, 24 -> 4) and,
    with `sphere_direction`, a 144-wide first layer of `outer_light`."""
    scfg = shape_config_from_dict({"shader_config": {"human_light": True,
                                                     "sphere_direction": True}})
    pj = jax.tree_util.tree_map(np.asarray, init_shape_params(jax.random.PRNGKey(1), scfg))
    pt = from_numpy_tree(pj)
    assert len(pt["shader"]) == 7 and len(pt["shader"]["human_light"]) == 4
    assert pt["shader"]["human_light"][0]["v"].shape == (24, 256)
    assert pt["shader"]["human_light"][3]["v"].shape == (256, 4)
    assert pt["shader"]["outer_light"][0]["v"].shape == (144, 256)
    back = to_numpy_tree(pt)
    for (k, a), (k2, b) in zip(tree_items(pj), tree_items(back)):
        assert k == k2
        np.testing.assert_array_equal(a, b, err_msg=k)
