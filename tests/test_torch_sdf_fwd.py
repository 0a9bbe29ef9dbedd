"""The value-only SDF function of the port (ops/sdf_fwd.py, its plain
version: the CUDA kernel runs on the card only) against nero_tpu's
`sdf_value` in f32 and against the TPU kernel `sdf_fwd_fused` in interpret
mode at that kernel's own bar (atol 2e-2: bf16 operands), and
`make_nograd_sdf_fn` with the switch on and off."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nero_tpu.fields.sdf import SDFConfig as JCfg, init_sdf, sdf_value as sdf_value_jax
from nero_tpu.ops.pallas.sdf_kernel import pack_sdf_params, sdf_fwd_fused
from nero_tpu_torch.core.convert import from_numpy_tree
from nero_tpu_torch.fields.sdf import SDFConfig
from nero_tpu_torch.ops import sdf_fwd as K
from nero_tpu_torch.ops.mlp import resolve_weight_norm
from nero_tpu_torch.render import shape as T

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def params_j():
    return jax.tree_util.tree_map(np.asarray, init_sdf(jax.random.PRNGKey(0), JCfg()))


def _pts(shape, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, shape + (3,)).astype(np.float32)


@pytest.mark.parametrize("shape,scale", [((600,), 1.0), ((601,), 1.0), ((3, 7), 1.0),
                                         ((2, 5, 11), 1.0), ((600,), 1.3)],
                         ids=["n600", "odd_n", "2d", "3d", "scale"])
def test_plain_matches_jax_f32_and_tpu_kernel(params_j, shape, scale):
    pts = _pts(shape)
    jcfg, cfg = JCfg(scale=scale), SDFConfig(scale=scale)
    pj = jax.tree_util.tree_map(jnp.asarray, params_j)
    ref = np.asarray(sdf_value_jax(pj, jnp.asarray(pts), jcfg))
    out = K.sdf_fwd(from_numpy_tree(params_j), torch.from_numpy(pts), cfg)
    assert out.shape == shape + (1,) and not out.requires_grad
    # f32 on both sides: summation order only
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=1e-4)
    fused = np.asarray(sdf_fwd_fused(pack_sdf_params(pj, jcfg), jnp.asarray(pts), jcfg,
                                     interpret=True))
    # tests/test_pallas_kernels.py:19: bf16 operands in the TPU kernel
    np.testing.assert_allclose(out.numpy(), fused, atol=2e-2)
    assert np.abs(out.numpy() - fused).mean() < 3e-3


def test_resolved_weights_and_no_grad(params_j):
    """Callers hand over resolved {w, b} layers (render resolves once); the
    result is the same and carries no graph."""
    pts = torch.from_numpy(_pts((64,)))
    p = from_numpy_tree(params_j)
    a = K.sdf_fwd(p, pts)
    b = K.sdf_fwd(resolve_weight_norm(p), pts.clone().requires_grad_(True))
    assert not b.requires_grad
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("on", [False, True])
def test_make_nograd_sdf_fn(params_j, on):
    scfg = T.shape_config_from_dict({"use_fused_sdf": on})
    assert scfg.use_fused_sdf is on
    params = {"sdf": resolve_weight_norm(from_numpy_tree(params_j))}
    fn = T.make_nograd_sdf_fn(params, scfg)
    pts = _pts((5, 9))
    ref = np.asarray(sdf_value_jax(jax.tree_util.tree_map(jnp.asarray, params_j),
                                   jnp.asarray(pts), JCfg()))
    with torch.no_grad():
        out = fn(torch.from_numpy(pts))
    assert out.shape == (5, 9, 1)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=1e-4)
    before = dict(K.launches)
    fn(torch.from_numpy(pts))
    assert K.launches == before, "a CPU tensor must not count as a kernel launch"


def test_unsupported_topology_raises_when_packing(params_j):
    with pytest.raises(NotImplementedError):
        K.pack_params(from_numpy_tree(params_j), SDFConfig(multires=4))


def test_bound_inputs():
    # 2 x (39*256 + 2*256*256 + 2*256*217 + 39*256 + 3*256*256 + 256) per point
    assert K.flops(1) == 2.0 * 459008
    assert K.min_bytes(131072) == 131072 * 16 + 2 * sum(r * c for r, c in K.PACK_SHAPES)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version(params_j):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    p = from_numpy_tree(params_j, device=dev)
    pts = torch.from_numpy(_pts((3, 1001))).to(dev)
    out, ref = K.sdf_fwd(p, pts), K.sdf_fwd_plain(p, pts)
    assert out.shape == (3, 1001, 1)
    torch.testing.assert_close(out, ref, atol=2e-2, rtol=0)
