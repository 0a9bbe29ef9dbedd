"""ops/march.py, ops/field_fwd.py and the `wide` field topology of the port on
the CPU: the plain versions of the uniform-march and field-forward kernels
against the TPU kernels `march_fused` / `field_fwd_fused` in interpret mode
and against nero_tpu's non-fused `neural_trace`, on small fields fitted to a
torus as tests/test_pallas_kernels.py builds them, at that file's bars
(agreement, not elementwise: `v <= 0` is a discrete decision and a grazing
ray may bracket another crossing). The CUDA kernels themselves are held
against the plain versions on the card by chip_smoke.py and by the
`gpu`-marked test."""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nero_tpu.geometry import neural_tracer as J
from nero_tpu.ops.pallas.field_kernel import field_fwd_fused, pack_field_params as pack_jax
from nero_tpu.ops.pallas.march_kernel import (_field_eval_t_wide, march_fused,
                                              sphere_march_fused)
from nero_tpu_torch import kernel_variants
from nero_tpu_torch.core.convert import from_numpy_tree
from nero_tpu_torch.geometry import neural_tracer as T
from nero_tpu_torch.ops import cuda_build
from nero_tpu_torch.ops import field_fwd as KF
from nero_tpu_torch.ops import march as KM
from nero_tpu_torch.ops import sphere_march as K

# one intra-op thread: the suite runs several worker processes side by side
torch.set_num_threads(1)

R = 256
TOPOLOGIES = ["std", "wide"]


def _fit(topology):
    """(JAX params, JAX packed, port params, port packed) of a field fitted
    to a torus."""
    def torus_sdf(p):
        q = jnp.stack([jnp.linalg.norm(p[..., :2], axis=-1) - 0.55, p[..., 2]], axis=-1)
        return jnp.linalg.norm(q, axis=-1) - 0.12

    params = J.init_field(jax.random.PRNGKey(0), topology=topology)
    opt = optax.adam(2e-3)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, key):
        pts = jax.random.uniform(key, (4096, 3), minval=-0.9, maxval=0.9)
        tgt = torus_sdf(pts)
        loss, g = jax.value_and_grad(
            lambda p: jnp.mean((J.field_apply(p, pts, topology=topology) - tgt) ** 2))(params)
        up, opt_state2 = opt.update(g, opt_state, params)
        return optax.apply_updates(params, up), opt_state2, loss

    key = jax.random.PRNGKey(3)
    for i in range(400):
        params, opt_state, loss = step(params, opt_state, jax.random.fold_in(key, i))
    assert float(loss) < 2e-3
    params_t = from_numpy_tree(jax.tree_util.tree_map(np.asarray, params), requires_grad=False)
    return (params, pack_jax(params, topology=topology), params_t,
            K.pack_field_params(params_t, topology=topology))


@pytest.fixture(scope="module")
def fitted():
    return {t: _fit(t) for t in TOPOLOGIES}


def _rays(n=R):
    """Rays from a sphere of radius 1.4 in random directions, as the JAX test."""
    rng = np.random.default_rng(4)
    o = rng.standard_normal((n, 3))
    o = 1.4 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (o.astype(np.float32), d.astype(np.float32), np.full(n, 0.012, np.float32),
            np.full(n, 2.8, np.float32))


def _agree(t_j, h_j, t_t, h_t):
    """Bars of tests/test_pallas_kernels.py: found agreement > 0.99 and
    median |dt| < 1e-3 on rays both found."""
    t_j, h_j, t_t, h_t = np.asarray(t_j), np.asarray(h_j), t_t.numpy(), h_t.numpy()
    assert h_j.any() and not h_j.all()
    assert (h_j == h_t).mean() > 0.99
    both = h_j & h_t
    assert np.median(np.abs(t_j[both] - t_t[both])) < 1e-3
    assert np.isfinite(t_t).all()


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_wide_field_bridges_and_matches_jax(topology):
    """core/convert.py carries the field of either topology; f32 field_apply
    on both sides: rtol 1e-5, atol 1e-5."""
    pj = J.init_field(jax.random.PRNGKey(0), topology=topology)
    pt = from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), requires_grad=False)
    shapes = [tuple(l["w"].shape) for l in pt["layers"]]
    assert shapes == ([(123, 128), (128, 128), (128, 1)] if topology == "wide"
                      else [(39, 128), (128, 128), (128, 128), (128, 1)])
    own = T.init_field(torch.Generator().manual_seed(0), topology=topology)
    assert [tuple(l["w"].shape) for l in own["layers"]] == shapes
    x = np.random.default_rng(0).uniform(-1, 1, (1024, 3)).astype(np.float32)
    ref = np.asarray(J.field_apply(pj, jnp.asarray(x), topology=topology))
    np.testing.assert_allclose(T.field_apply(pt, torch.from_numpy(x), topology=topology).numpy(),
                               ref, rtol=1e-5, atol=1e-5)


def test_wide_encode_matches_jax():
    assert T.WIDE_CHAINS == J.WIDE_CHAINS and T.WIDE_DIM == J.WIDE_DIM == 123
    x = np.random.default_rng(1).uniform(-1.1, 1.1, (2048, 3)).astype(np.float32)
    ref = np.asarray(J.wide_encode(jnp.asarray(x)))
    np.testing.assert_allclose(T.wide_encode(torch.from_numpy(x)).numpy(), ref, atol=1e-6)
    # the kernels' double-angle recurrence: f32 drift at 5 octaves under 5e-5
    np.testing.assert_allclose(K.pe_rows_wide(torch.from_numpy(x)).numpy(), ref, atol=5e-5)


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_pack_field_params_layout(fitted, topology):
    """The layouts of nero_tpu/ops/pallas/field_kernel.py:26-52, key by key,
    and the kernels' buffers made from them."""
    _, packed_j, _, packed_t = fitted[topology]
    assert set(packed_j) == set(packed_t)
    for k, v in packed_j.items():
        np.testing.assert_array_equal(np.asarray(v), packed_t[k].numpy(), err_msg=k)
    assert K.topology_of(packed_t) == topology
    W, Fv = K.kernel_buffers(packed_t)
    wide = topology == "wide"
    assert W.dtype == torch.bfloat16 and W.shape == ((256, 128) if wide else (304, 128))
    assert (W.numel(), Fv.numel()) == K.buffer_elems(wide)
    last_b = packed_t["b2"] if wide else packed_t["b3"]
    assert Fv[-4] == last_b[0, 0]
    with pytest.raises(ValueError):
        K.check_packed(packed_t, "std" if wide else "wide", 6, kernel=False)


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_march_plain_matches_pallas_interpret(fitted, topology):
    _, packed_j, _, packed_t = fitted[topology]
    rays = _rays()
    kw = dict(n_coarse=32, n_refine=8)
    t_j, h_j = march_fused(packed_j, *map(jnp.asarray, rays), interpret=True,
                           topology=topology, **kw)
    t_t, h_t = KM.march_plain(packed_t, *map(torch.from_numpy, rays), **kw)
    _agree(t_j, h_j, t_t, h_t)


def test_sphere_march_plain_wide_matches_pallas_interpret(fitted):
    _, packed_j, _, packed_t = fitted["wide"]
    rays = _rays()
    kw = dict(n_sphere=18, n_refine=2, dt_frac=1.0 / 31.0, margin=0.004, refine="illinois")
    t_j, h_j = sphere_march_fused(packed_j, *map(jnp.asarray, rays), interpret=True,
                                  topology="wide", **kw)
    t_t, h_t = K.sphere_march(packed_t, *map(torch.from_numpy, rays), topology="wide", **kw)
    _agree(t_j, h_j, t_t, h_t)


def test_field_fwd_plain_matches_pallas_interpret(fitted):
    """`std` (the topology the TPU kernel takes): same rounding points, so
    atol 1e-3 to the kernel and tests/test_pallas_kernels.py's atol 2e-2 to
    the f32 field."""
    params_j, packed_j, params_t, packed_t = fitted["std"]
    x = np.random.default_rng(1).uniform(-0.9, 0.9, (5, 300, 3)).astype(np.float32)
    ref = np.asarray(field_fwd_fused(packed_j, jnp.asarray(x), interpret=True))
    out = KF.field_fwd(packed_t, torch.from_numpy(x))
    assert out.shape == (5, 300) and not out.requires_grad
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-3)
    f32 = T.field_apply(params_t, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out.numpy(), f32, atol=2e-2)


def test_field_fwd_plain_wide_matches_tpu_kernel_body(fitted):
    """`wide`: against the TPU march kernel's `_field_eval_t_wide` run as
    plain jnp (atol 1e-3) and against the f32 field (atol 2e-2)."""
    _, packed_j, params_t, packed_t = fitted["wide"]
    x = np.random.default_rng(2).uniform(-0.9, 0.9, (2048, 3)).astype(np.float32)
    names = ["w0", "b0", "w1", "b1", "w2t", "b2"]
    ref = np.asarray(_field_eval_t_wide(jnp.asarray(x.T), *[packed_j[k] for k in names]))[0]
    out = KF.field_fwd(packed_t, torch.from_numpy(x), topology="wide").numpy()
    np.testing.assert_allclose(out, ref, atol=1e-3)
    f32 = T.field_apply(params_t, torch.from_numpy(x), topology="wide").numpy()
    np.testing.assert_allclose(out, f32, atol=2e-2)


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_uniform_trace_matches_jax_nonfused(fitted, topology):
    """The port's `uniform` march mode against nero_tpu's non-fused (all-f32)
    neural_trace with the same n_coarse and n_refine: same hits (> 0.99),
    same depth (median |dt| < 1e-3), normals within 0.995 on rays both hit."""
    params_j, _, params_t, packed_t = fitted[topology]
    o = _rays()[0]
    # aimed at the tube's centre line with a spread, so that about half hit
    rng = np.random.default_rng(6)
    phi = rng.uniform(0, 2 * np.pi, R)
    target = np.stack([0.55 * np.cos(phi), 0.55 * np.sin(phi), np.zeros(R)], -1)
    d = target + 0.15 * rng.standard_normal((R, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    kw = dict(n_coarse=32, n_refine=8)
    try:
        t_j, n_j, h_j = J.neural_trace(params_j, params_j, jnp.asarray(o), jnp.asarray(d), 1.0,
                                       use_fused=False, topology=topology, **kw)
    finally:
        J.neural_trace.clear_cache()
    t_t, n_t, h_t = T.neural_trace(params_t, packed_t, torch.from_numpy(o), torch.from_numpy(d),
                                   1.0, march_mode="uniform", topology=topology, **kw)
    _agree(t_j, h_j, t_t, h_t)
    both = np.asarray(h_j) & h_t.numpy()
    # the bf16-operand march and the f32 march stop ~1e-3 apart: the normals
    # at the two points agree to 0.995 on average (grazing rays less)
    assert both.sum() > 50
    assert np.sum(np.asarray(n_j)[both] * n_t.numpy()[both], -1).mean() > 0.995
    miss = ~np.asarray(h_j) & ~h_t.numpy()
    assert (t_t.numpy()[miss] == 10.0).all() and (n_t.numpy()[miss] == 0).all()
    with pytest.raises(NotImplementedError):
        T.neural_trace(params_t, packed_t, torch.from_numpy(o), torch.from_numpy(d), 1.0,
                       march_mode="zigzag", topology=topology)


def test_sample_positions_are_not_accumulated():
    """t_i = t_enter + dt * i, formed so: a running sum t += dt drifts by a
    few ulp over 31 steps and moves brackets on grazing rays."""
    packed = K.pack_field_params(T.init_field(torch.Generator().manual_seed(0)))
    seen = []
    real = KM.field_eval_plain
    KM.field_eval_plain = lambda pk, pts, pe: (seen.append(pts[:, 2].clone()), real(pk, pts, pe))[1]
    try:
        o, d = torch.zeros(3, 3), torch.tensor([[0.0, 0.0, 1.0]]).repeat(3, 1)
        t_enter = torch.tensor([0.012, 0.1, 0.3])
        t_exit = torch.tensor([1.9, 1.7, 0.9])
        KM.march_plain(packed, o, d, t_enter, t_exit, n_coarse=32, n_refine=0)
    finally:
        KM.field_eval_plain = real
    dt = (t_exit - t_enter) / 31
    assert len(seen) == 32
    for i, z in enumerate(seen):
        assert torch.equal(z, t_enter + dt * float(i)) or i == 0
    assert torch.equal(seen[0], t_enter)


def test_start_inside_rule(fitted):
    """A ray that starts inside the surface at its origin (t_enter == t0) is
    found with the bracket [t_enter, t_enter]; one that enters the bounding
    sphere later is not."""
    _, _, _, packed_t = fitted["std"]
    o = torch.tensor([[0.55, 0.0, 0.0], [0.55, 0.0, 0.0]])       # inside the torus tube
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    t_enter = torch.tensor([0.012, 0.05])
    t_exit = torch.tensor([0.08, 0.08])                           # stays inside the tube
    t, found = KM.march(packed_t, o, d, t_enter, t_exit, n_coarse=8, n_refine=4)
    assert found.tolist() == [True, False]
    assert t[0] == pytest.approx(0.012, abs=1e-7) and t[1] == pytest.approx(0.05, abs=1e-7)


def test_wrappers_run_plain_on_cpu_tensors(fitted):
    _, _, _, packed_t = fitted["wide"]
    rays = tuple(map(torch.from_numpy, _rays()))
    before = (dict(KM.launches), dict(KF.launches), dict(K.launches))
    t_w, h_w = KM.march(packed_t, *rays, n_coarse=16, n_refine=2, topology="wide")
    t_p, h_p = KM.march_plain(packed_t, *rays, n_coarse=16, n_refine=2)
    assert torch.equal(t_w, t_p) and torch.equal(h_w, h_p)
    assert h_w.dtype == torch.bool and not t_w.requires_grad
    v = KF.field_fwd(packed_t, rays[0], topology="wide")
    assert torch.equal(v, KF.field_fwd_plain(packed_t, rays[0]))
    assert (KM.launches, KF.launches, K.launches) == before   # no launch for CPU tensors
    with pytest.raises(ValueError):
        KM.march(packed_t, *rays, topology="std")             # not the packed field's
    with pytest.raises(ValueError):
        KM.march(packed_t, *rays, n_coarse=1, topology="wide")


def test_work_per_launch():
    """393,216 rays x (32 + 8) evaluations; wide has 0.85x the operations."""
    assert K.EVAL_FLOPS_WIDE == 2 * (123 * 128 + 128 * 128 + 128) == 64512
    assert KM.flops(393216, 32, 8) == pytest.approx(2 * K.flops(393216, 18, 2), rel=1e-9)
    assert KM.flops(393216, 32, 8, "wide") == 393216 * 40 * 64512
    assert KF.flops(393216) == 393216 * 75776
    assert KF.min_bytes(393216) == 393216 * 16 + 304 * 128 * 2
    assert K.min_bytes(393216, "wide") == 393216 * 40 + 256 * 128 * 2


def _read(fn):
    with open(os.path.join(cuda_build.CSRC, fn)) as f:
        return f.read()


def test_field_kernels_run_on_the_warp_engine():
    """The three kernels of the distilled field run on csrc/field.cuh's
    warp-tile engine: no block_mm and no barrier of their own; the engine
    keeps no block path, and its one __syncthreads is the prologue's."""
    for fn in ("sphere_march.cu", "march.cu", "field_fwd.cu"):
        src = _read(fn)
        assert "block_mm" not in src and "__syncthreads()" not in src, fn
        assert "field_prologue<WIDE," in src and src.count("field16<WIDE, PE>(") == 1, fn
    engine = _read("field.cuh")
    prologue = engine[engine.index("WarpField field_prologue("):]
    prologue = prologue[:prologue.index("\n}\n")]
    assert engine.count("__syncthreads()") == prologue.count("__syncthreads()") == 1
    for fn in os.listdir(cuda_build.CSRC):
        if fn.endswith((".cu", ".cuh")):
            src = _read(fn)
            for gone in ("field_eval", "field_load", "field_carve", "FieldSmem",
                         "bias_relu_store", "field_encode"):
                assert not re.search(rf"\b{gone}\b", src), (fn, gone)


def test_tile_is_the_warp_tile():
    """The wrappers check the kernels' 16-row warp tile against this."""
    assert K.TILE == 16 and "constexpr int FD_TILE = 16;" in _read("field.cuh")


@pytest.mark.parametrize("name", list(kernel_variants.MARCH_VARIANTS))
def test_every_march_variant_patch_applies(name):
    """A stale patch shows only on the card: each variant's every (old, new)
    pair must find its text in csrc/march.cu or in the engine's
    csrc/field.cuh as they are, and change it."""
    files = kernel_variants.variant_files(name, "march")
    assert "march.cu" in files and set(files) <= {"march.cu", "field.cuh"}
    changed = any(text != _read(fn) for fn, text in files.items())
    assert changed == bool(kernel_variants.MARCH_VARIANTS[name])


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions(fitted):
    """At 256 rays and points, at 1,001 (not a multiple of the 16-row warp
    tile) and at 0 (empty, correctly typed outputs, no launch counted): the
    march's found agreement > 0.99 and median |dt| < 1e-3, the field within
    1e-3 of its plain version and 2e-2 of the f32 field."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    for n in (R, 1001, 0):
        rays = tuple(torch.from_numpy(a).to(dev) for a in _rays(n))
        for topology in TOPOLOGIES:
            _, _, params_t, packed_t = fitted[topology]
            packed = {k: v.to(dev) for k, v in packed_t.items()}
            before = (dict(KM.launches), dict(KF.launches))
            t_k, h_k = KM.march(packed, *rays, n_coarse=32, n_refine=8, topology=topology)
            v_k = KF.field_fwd(packed, rays[0], topology=topology)
            inside = 0.6 * rays[0]   # within the fitted box
            v_in = KF.field_fwd(packed, inside, topology=topology)
            torch.cuda.synchronize()
            assert t_k.shape == h_k.shape == v_k.shape == (n,)
            assert t_k.dtype == v_k.dtype == torch.float32 and h_k.dtype == torch.bool
            if n == 0:
                assert (KM.launches, KF.launches) == before
                continue
            t_p, h_p = KM.march_plain(packed, *rays, n_coarse=32, n_refine=8)
            assert torch.isfinite(t_k).all()
            assert (h_k == h_p).float().mean() > 0.99
            assert (t_k - t_p).abs()[h_k & h_p].median() < 1e-3
            assert (v_k - KF.field_fwd_plain(packed, rays[0])).abs().max() < 1e-3
            f32 = T.field_apply(params_t, inside.cpu(), topology=topology)
            assert (v_in.cpu() - f32).abs().max() < 2e-2
