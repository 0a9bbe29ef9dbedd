"""The predictor head of the port (ops/predictor.py, its plain version: the
CUDA kernel runs on the card only) against nero_tpu's `apply_predictor` body
in f32 and against the TPU kernel `predictor_fused` in interpret mode at the
bars of tests/test_predictor_kernel.py, values and gradients to x and to
the {v, g, b} leaves."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nero_tpu.ops.mlp import apply_predictor as apply_jax, hidden_dtype, init_predictor
from nero_tpu.ops.pallas.predictor_kernel import predictor_fused
from nero_tpu_torch.core.convert import from_numpy_tree, tree_items
from nero_tpu_torch.ops import predictor as K
from nero_tpu_torch.ops.mlp import apply_predictor

torch.set_num_threads(1)

# tests/test_predictor_kernel.py's shapes, then the Stage-I shader's own
HEAD_SHAPES = [(259, 3), (72, 3), (123, 3), (90, 1), (259, 1), (144, 3), (24, 4)]
N = 300


def _setup(d_in, d_out, shape=(N,)):
    layers = jax.tree_util.tree_map(np.asarray,
                                    init_predictor(jax.random.PRNGKey(d_in), d_in, d_out))
    rng = np.random.default_rng(d_in + d_out)
    x = (rng.standard_normal(shape + (d_in,)) * 0.5).astype(np.float32)
    cot = rng.standard_normal(shape + (d_out,)).astype(np.float32)
    return layers, x, cot


@pytest.mark.parametrize("d_in,d_out", HEAD_SHAPES)
def test_forward(d_in, d_out):
    layers, x, _ = _setup(d_in, d_out)
    ref = np.asarray(apply_jax(layers, jnp.asarray(x), activation="none"))
    with torch.no_grad():
        out = K.predictor(from_numpy_tree(layers), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-4)   # f32 both sides
    fused = np.asarray(predictor_fused(layers, jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(out, fused, atol=2e-3, rtol=1e-2)  # the TPU kernel's bar


@pytest.mark.parametrize("activation,exp_max", [("sigmoid", 0.0), ("exp", 0.0), ("exp", 5.0),
                                                ("none", 0.0)])
def test_apply_predictor_fused_switch(activation, exp_max):
    """`fused=True` on a CPU tensor is the plain version behind the same
    activation: equal to `fused=False` and to nero_tpu."""
    layers, x, _ = _setup(72, 3)
    ref = np.asarray(apply_jax(layers, jnp.asarray(x), activation=activation, exp_max=exp_max))
    p = from_numpy_tree(layers)
    with torch.no_grad():
        a = apply_predictor(p, torch.from_numpy(x), activation, exp_max, fused=True)
        b = apply_predictor(p, torch.from_numpy(x), activation, exp_max, fused=False)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    np.testing.assert_allclose(a.numpy(), ref, atol=1e-5, rtol=1e-4)


def _port_grads(layers, x, cot):
    p = from_numpy_tree(layers)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = (K.predictor(p, xt) * torch.from_numpy(cot)).sum()
    leaves = [v for _, v in tree_items(p)] + [xt]
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _jax_grads(kind, layers, x, cot):
    def loss(p, xx):
        if kind == "fused":
            return jnp.sum(predictor_fused(p, xx, interpret=True) * cot)
        if kind == "bf16":
            with hidden_dtype(jnp.bfloat16):
                return jnp.sum(apply_jax(p, xx, activation="none") * cot)
        return jnp.sum(apply_jax(p, xx, activation="none") * cot)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(layers, jnp.asarray(x))
    gp = jax.tree_util.tree_map(np.asarray, gp)
    return [a for _, a in tree_items(gp)] + [np.asarray(gx)]


@pytest.mark.parametrize("d_in,d_out", [(259, 3), (144, 3), (24, 4), (90, 1)])
def test_grads_match_xla_f32(d_in, d_out):
    """Every {v, g, b} leaf and x: normalised max error < 1e-4 (f32)."""
    layers, x, cot = _setup(d_in, d_out)
    for a, b in zip(_jax_grads("xla", layers, x, cot), _port_grads(layers, x, cot)):
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b / scale, a / scale, atol=1e-4)


def test_grads_vs_tpu_kernel_at_its_bar():
    """tests/test_predictor_kernel.py:30-75 with the port's plain version as
    the f32 reference: the bf16 kernel's worst mean error under 1.5x the
    bf16-XLA path's + 1e-4, every leaf within cosine 0.99, d x mean error
    under 0.02 of its max."""
    layers, x, cot = _setup(259, 3, (700,))
    g32 = _port_grads(layers, x, cot)
    gbf = _jax_grads("bf16", layers, x, cot)
    gk = _jax_grads("fused", layers, x, cot)

    def worst_mean_rel(ga, gb):
        return max(float((np.abs(a - b) / (np.abs(a).max() + 1e-8)).mean()) for a, b in zip(ga, gb))

    assert worst_mean_rel(g32[:-1], gk[:-1]) < 1.5 * worst_mean_rel(g32[:-1], gbf[:-1]) + 1e-4
    for a, b in zip(g32, gk):
        a, b = a.ravel(), b.ravel()
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12) > 0.99
    assert (np.abs(g32[-1] - gk[-1]) / (np.abs(g32[-1]).max() + 1e-8)).mean() < 0.02


def test_odd_row_count_and_leading_shape():
    layers, x, _ = _setup(72, 3, (3, 7))   # 21 rows, ragged
    ref = np.asarray(apply_jax(layers, jnp.asarray(x), activation="none"))
    with torch.no_grad():
        out = K.predictor(from_numpy_tree(layers), torch.from_numpy(x))
    assert out.shape == (3, 7, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-4)


def test_packing_round_trip_and_bounds():
    """The kernel layout (w1 padded to a multiple of 16 rows, w4 to 16
    columns, biases [4, 256]) holds the weights unchanged up to bf16."""
    layers, _, _ = _setup(123, 3)
    p = from_numpy_tree(layers)
    from nero_tpu_torch.ops.mlp import resolve_weight_norm
    res = resolve_weight_norm(p)
    ws, bs = [l["w"].detach() for l in res], [l["b"].detach() for l in res]
    assert K.supported(ws) and K.padded_d_in(123) == 128 and K.padded_d_in(259) == 272
    W, B = K.pack_weights(ws, bs)
    assert W.dtype == torch.bfloat16 and W.numel() == 128 * 256 + 2 * 256 * 256 + 256 * 16
    w1 = W[:128 * 256].view(128, 256).float()
    torch.testing.assert_close(w1[:123], ws[0].to(torch.bfloat16).float(), atol=0, rtol=0)
    assert torch.all(w1[123:] == 0)
    w4 = W[-256 * 16:].view(256, 16).float()
    assert torch.all(w4[:, 3:] == 0)
    torch.testing.assert_close(B[3, :3], bs[3], atol=0, rtol=0)
    assert K.flops(10, 259, 3) == 2.0 * 10 * (259 * 256 + 2 * 256 * 256 + 256 * 3)
    # the backward: the hidden layers' recompute (the output layer's value is
    # not needed), dW of all four layers, the cotangents down to the input
    assert K.flops(10, 259, 3, backward=True) == 2.0 * 10 * (
        3 * 259 * 256 + 6 * 256 * 256 + 2 * 256 * 3)
    assert K.bwd_flops_per_row(259, 3, want_dx=False) == 2.0 * (
        2 * 259 * 256 + 6 * 256 * 256 + 2 * 256 * 3)
    assert not K.supported([torch.zeros(300, 256), *ws[1:]])


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    layers, x, _ = _setup(259, 3, (1001,))
    dev = torch.device("cuda")
    p = from_numpy_tree(layers, device=dev)
    xt = torch.from_numpy(x).to(dev)
    with torch.no_grad():
        torch.testing.assert_close(K.predictor(p, xt), K.predictor_plain(p, xt),
                                   atol=2e-3, rtol=1e-2)
