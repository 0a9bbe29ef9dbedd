"""ops/sphere_march.py on the CPU: the plain version of the sphere-march
kernel against the TPU kernel `sphere_march_fused` in interpret mode, on
small fields (`std` and `wide`) fitted to a torus as
tests/test_pallas_kernels.py builds them, at that file's bars (agreement, not
elementwise: `v <= 0` is a discrete decision and a grazing ray may bracket
another crossing). The CUDA kernel itself is held against the plain version
on the card by chip_smoke.py and by the `gpu`-marked test; the patches of
its variants in kernel_variants.py are checked here."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nero_tpu.geometry.neural_tracer import field_apply as field_apply_jax, init_field
from nero_tpu.ops.pallas.field_kernel import pack_field_params as pack_jax
from nero_tpu.ops.pallas.march_kernel import _field_eval_t, sphere_march_fused
from nero_tpu.utils.encodings import positional_encode
from nero_tpu_torch import kernel_variants
from nero_tpu_torch.core.convert import from_numpy_tree
from nero_tpu_torch.ops import cuda_build
from nero_tpu_torch.ops import sphere_march as K

# one intra-op thread: the suite runs several worker processes side by side
torch.set_num_threads(1)

R = 256
TOPOLOGIES = ["std", "wide"]


def _fit(topology):
    """(JAX params, JAX packed, port packed) of a field fitted to a torus."""
    def torus_sdf(p):
        q = jnp.stack([jnp.linalg.norm(p[..., :2], axis=-1) - 0.55, p[..., 2]], axis=-1)
        return jnp.linalg.norm(q, axis=-1) - 0.12

    params = init_field(jax.random.PRNGKey(0), topology=topology)
    opt = optax.adam(2e-3)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, key):
        pts = jax.random.uniform(key, (4096, 3), minval=-0.9, maxval=0.9)
        tgt = torus_sdf(pts)
        loss, g = jax.value_and_grad(
            lambda p: jnp.mean((field_apply_jax(p, pts, topology=topology) - tgt) ** 2))(params)
        up, opt_state2 = opt.update(g, opt_state, params)
        return optax.apply_updates(params, up), opt_state2, loss

    key = jax.random.PRNGKey(3)
    for i in range(400):
        params, opt_state, loss = step(params, opt_state, jax.random.fold_in(key, i))
    assert float(loss) < 2e-3
    params_t = from_numpy_tree(jax.tree_util.tree_map(np.asarray, params),
                               requires_grad=False)
    return (params, pack_jax(params, topology=topology),
            K.pack_field_params(params_t, topology=topology))


@pytest.fixture(scope="module")
def fields():
    """Topology -> (JAX params, JAX packed, port packed)."""
    return {t: _fit(t) for t in TOPOLOGIES}


@pytest.fixture(scope="module")
def fitted(fields):
    return fields["std"]


def _rays(n=R):
    """Rays from a sphere of radius 1.4 in random directions, as the JAX test."""
    rng = np.random.default_rng(4)
    o = rng.standard_normal((n, 3))
    o = 1.4 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (o.astype(np.float32), d.astype(np.float32), np.full(n, 0.012, np.float32),
            np.full(n, 2.8, np.float32))


def _both(fitted, refine, n_refine, n=R, topology="std", n_sphere=16):
    _, packed_j, packed_t = fitted
    rays = _rays(n)
    kw = dict(n_sphere=n_sphere, n_refine=n_refine, dt_frac=1.0 / 31.0, margin=0.004,
              refine=refine)
    t_j, h_j = sphere_march_fused(packed_j, *map(jnp.asarray, rays), interpret=True,
                                  topology=topology, **kw)
    t_t, h_t = K.sphere_march_plain(packed_t, *map(torch.from_numpy, rays), **kw)
    return np.asarray(t_j), np.asarray(h_j), t_t.numpy(), h_t.numpy()


def _agree(t_j, h_j, t_t, h_t):
    """Bars of tests/test_pallas_kernels.py:105-109: found agreement > 0.99
    and median |dt| < 1e-3 on rays both found."""
    assert h_j.any() and not h_j.all()
    assert (h_j == h_t).mean() > 0.99
    both = h_j & h_t
    assert np.median(np.abs(t_j[both] - t_t[both])) < 1e-3
    assert np.isfinite(t_t).all()


@pytest.mark.parametrize("refine,n_refine", [("illinois", 3), ("illinois", 2), ("bisect", 8)])
def test_plain_matches_pallas_interpret(fitted, refine, n_refine):
    _agree(*_both(fitted, refine, n_refine))


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_ragged_ray_count_matches_pallas_interpret(fields, topology):
    """1,001 rays, a multiple of neither the CUDA kernel's 16-ray warp tile
    nor the 128-ray tiles of the TPU kernel and field.cuh: the Stage-II
    defaults (18 sphere steps, 2 Illinois steps) at the same bars."""
    out = _both(fields[topology], "illinois", 2, n=1001, topology=topology, n_sphere=18)
    assert out[2].shape == out[3].shape == (1001,)
    _agree(*out)


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_zero_rays(fields, topology):
    """No rays: an empty f32 t and an empty bool found, without error."""
    _, _, packed_t = fields[topology]
    empty = tuple(torch.from_numpy(a[:0]) for a in _rays(1))
    for refine in ("illinois", "bisect"):
        t, found = K.sphere_march(packed_t, *empty, n_sphere=18, n_refine=2, refine=refine,
                                  topology=topology)
        assert t.shape == found.shape == (0,)
        assert t.dtype == torch.float32 and found.dtype == torch.bool


def test_refine_mode_keeps_found(fitted):
    """`found` is decided by the march: the refine mode must not change it."""
    _, _, _, h_i = _both(fitted, "illinois", 3)
    _, _, _, h_b = _both(fitted, "bisect", 8)
    assert (h_i == h_b).all()


def test_degenerate_rays_stay_finite(fitted):
    """Rays that miss the bounding sphere get t_exit = t_enter + 1e-3, and
    rays that never cross keep the bracket [t_enter, t_enter]."""
    _, _, packed_t = fitted
    o = torch.tensor([[0.0, 0.0, 3.0], [0.0, 0.0, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    t_enter = torch.tensor([0.012, 0.012])
    t_exit = torch.tensor([0.013, 0.012 + 1e-3])
    for refine in ("illinois", "bisect"):
        t, found = K.sphere_march_plain(packed_t, o, d, t_enter, t_exit, n_sphere=18,
                                        n_refine=2, refine=refine)
        assert torch.isfinite(t).all()
        assert not found[0]
        assert t[0] == pytest.approx(0.012, abs=1e-6)


def test_pe_recurrence_matches_exact():
    """Double-angle recurrence against sin/cos of every octave; f32 drift at
    6 octaves stays under 5e-5."""
    x = np.random.default_rng(0).uniform(-1.1, 1.1, (4096, 3)).astype(np.float32)
    exact = np.asarray(positional_encode(jnp.asarray(x), 6))
    np.testing.assert_allclose(K.pe_rows(torch.from_numpy(x)).numpy(), exact, atol=5e-5)


def test_pack_field_params_layout(fitted):
    """The layout of nero_tpu/ops/pallas/field_kernel.py:45-52, key by key."""
    _, packed_j, packed_t = fitted
    assert set(packed_j) == set(packed_t)
    for k, v in packed_j.items():
        assert tuple(v.shape) == tuple(packed_t[k].shape), k
        np.testing.assert_array_equal(np.asarray(v), packed_t[k].numpy(), err_msg=k)
    W, Fv = K.kernel_buffers(packed_t)
    assert W.dtype == torch.bfloat16 and W.shape == (48 + 128 + 128, 128)
    assert Fv.shape == (4 * 128 + 4,)
    assert Fv[512] == packed_t["b3"][0, 0]


def test_field_eval_matches_tpu_kernel_body(fitted):
    """The bf16-operand field evaluation against the TPU kernel's
    `_field_eval_t` run as plain jnp: same rounding points, so they differ
    in summation order only (atol 1e-3 on values of order 0.1-1)."""
    _, packed_j, packed_t = fitted
    x = np.random.default_rng(1).uniform(-0.9, 0.9, (2048, 3)).astype(np.float32)
    names = ["w0", "b0", "w1", "b1", "w2", "b2", "w3t", "b3"]
    ref = np.asarray(_field_eval_t(jnp.asarray(x.T), *[packed_j[k] for k in names], 6))[0]
    out = K.field_eval_plain(packed_t, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-3)


def test_wrapper_runs_plain_on_cpu_tensors(fitted):
    _, _, packed_t = fitted
    rays = tuple(map(torch.from_numpy, _rays()))
    before = K.launches["sphere_march"]
    t_w, h_w = K.sphere_march(packed_t, *rays, n_sphere=18, n_refine=2, refine="illinois")
    t_p, h_p = K.sphere_march_plain(packed_t, *rays, n_sphere=18, n_refine=2,
                                    refine="illinois")
    assert K.launches["sphere_march"] == before   # no kernel launch for CPU tensors
    assert torch.equal(t_w, t_p) and torch.equal(h_w, h_p)
    assert h_w.dtype == torch.bool and not t_w.requires_grad


def test_work_per_launch():
    """393,216 rays x 20 evaluations: 5.96e11 operations, 15.7 MB + weights."""
    assert K.EVAL_FLOPS == 75776
    assert K.flops(393216, 18, 2) == pytest.approx(5.959e11, rel=1e-3)
    assert K.min_bytes(393216) == 393216 * 40 + 304 * 128 * 2


@pytest.mark.parametrize("name", list(kernel_variants.SPHERE_VARIANTS))
def test_every_variant_patch_applies(name):
    """A stale patch shows only on the card: each variant's every (old, new)
    pair must find its text in csrc/sphere_march.cu or in the engine's
    csrc/field.cuh as they are, and change it."""
    files = kernel_variants.variant_files(name, "sphere_march")
    assert "sphere_march.cu" in files and set(files) <= {"sphere_march.cu", "field.cuh"}
    changed = False
    for fn, text in files.items():
        with open(os.path.join(cuda_build.CSRC, fn)) as f:
            changed |= text != f.read()
    assert changed == bool(kernel_variants.SPHERE_VARIANTS[name])


@pytest.mark.gpu
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_cuda_kernel_matches_plain_version(fields, topology):
    """Both refine modes at 0, 1, 1,001 and 65,536 rays: empty outputs at 0,
    elsewhere found agreement > 0.99 and median |dt| < 1e-3, and the refine
    mode keeps `found`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _, _, packed_t = fields[topology]
    dev = torch.device("cuda")
    packed = {k: v.to(dev) for k, v in packed_t.items()}
    all_rays = tuple(torch.from_numpy(a).to(dev) for a in _rays(65536))
    for n in (0, 1, 1001, 65536):
        rays = tuple(a[:n] for a in all_rays)
        found = {}
        for refine, n_refine in (("illinois", 2), ("bisect", 8)):
            kw = dict(n_sphere=18, n_refine=n_refine, refine=refine)
            t_k, h_k = K.sphere_march(packed, *rays, topology=topology, **kw)
            t_p, h_p = K.sphere_march_plain(packed, *rays, **kw)
            torch.cuda.synchronize()
            assert t_k.shape == h_k.shape == (n,)
            assert t_k.dtype == torch.float32 and h_k.dtype == torch.bool
            found[refine] = h_k
            if n == 0:
                continue
            assert torch.isfinite(t_k).all()
            assert (h_k == h_p).float().mean() > 0.99
            both = h_k & h_p
            if bool(both.any()):
                assert (t_k - t_p).abs()[both].median() < 1e-3
        assert torch.equal(found["illinois"], found["bisect"])
