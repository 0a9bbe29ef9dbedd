"""geometry/neural_tracer.py of the port on the CPU: the field against
nero_tpu's on bridged weights, a small distillation against the exact host
BVH (the checks of tests/test_neural_tracer.py), and the whole `neural_trace`
against nero_tpu's fused path in interpret mode."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nero_tpu.geometry import neural_tracer as J
from nero_tpu.ops.pallas.field_kernel import pack_field_params as pack_jax
from nero_tpu.ops.pallas.interp import force_interpret
from nero_tpu_torch.core.convert import from_numpy_tree, to_numpy_tree
from nero_tpu_torch.geometry import neural_tracer as T
from nero_tpu_torch.geometry.proc_mesh import proc_mesh
from nero_tpu_torch.ops.sphere_march import pack_field_params

# one intra-op thread: the suite runs several worker processes side by side
torch.set_num_threads(1)

SMALL = dict(distill_steps=300, distill_samples=120_000, distill_batch=16384, verbose=False)


@pytest.fixture(scope="module")
def sphere_mesh():
    return proc_mesh("sphere", grid=48, lo=-1.0, hi=1.0)


@pytest.fixture(scope="module")
def tracer(sphere_mesh, tmp_path_factory):
    old = T.NeuralTracer.CACHE_DIR
    T.NeuralTracer.CACHE_DIR = str(tmp_path_factory.mktemp("tracer_cache"))
    try:
        return T.NeuralTracer(sphere_mesh["vertices"], sphere_mesh["triangles"], **SMALL)
    finally:
        T.NeuralTracer.CACHE_DIR = old


def _surface_rays(n=2048, radius=0.5, seed=0):
    rng = np.random.RandomState(seed)
    p = rng.normal(size=(n, 3))
    p = (p / np.linalg.norm(p, axis=-1, keepdims=True) * radius).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (p + d * 1e-5).astype(np.float32), d


def test_field_apply_matches_jax():
    """f32 on both sides, bridged weights: rtol 1e-5, atol 1e-5."""
    pj = J.init_field(jax.random.PRNGKey(0))
    pt = from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), requires_grad=False)
    assert [set(l) for l in pt["layers"]] == [{"w", "b"}] * 4
    x = np.random.default_rng(0).uniform(-1, 1, (1024, 3)).astype(np.float32)
    ref = np.asarray(J.field_apply(pj, jnp.asarray(x)))
    np.testing.assert_allclose(T.field_apply(pt, torch.from_numpy(x)).numpy(), ref,
                               rtol=1e-5, atol=1e-5)


def test_init_field_shapes():
    p = T.init_field(torch.Generator().manual_seed(0))
    assert [tuple(l["w"].shape) for l in p["layers"]] == [(39, 128), (128, 128), (128, 128),
                                                          (128, 1)]


def test_warmup_cosine_matches_optax():
    import optax
    sched = optax.warmup_cosine_decay_schedule(0.0, 2e-3, 30, 300, 1e-4)
    for s in (0, 1, 15, 30, 31, 150, 299, 300):
        assert T.warmup_cosine_lr(s, 2e-3, 30, 300, 1e-4) == pytest.approx(float(sched(s)),
                                                                          rel=1e-5, abs=1e-9)


def test_training_points_match_jax(sphere_mesh):
    """The sampler is numpy with a seeded RandomState: bit-identical."""
    v, t = sphere_mesh["vertices"], sphere_mesh["triangles"]
    a = J._sample_training_points(v, t, 700, 300, 1.05, np.random.RandomState(3))
    b = T._sample_training_points(v, t, 700, 300, 1.05, np.random.RandomState(3))
    np.testing.assert_array_equal(a, b)


def test_distillation_quality(tracer):
    assert tracer.distill_rms < 0.01, tracer.distill_rms
    assert tracer.margin == max(0.002, 3.0 * tracer.distill_rms)


def test_trace_agreement_with_exact(tracer):
    """Surface-origin rays against the exact host BVH: > 0.93 agreement, as
    tests/test_neural_tracer.py:36-57 asks of a 300-step field."""
    o, d = _surface_rays()
    _, nc, dc, hc = tracer.trace_cpu(o, d)
    _, ng, dg, hg = (x.numpy() for x in tracer.trace(torch.from_numpy(o), torch.from_numpy(d)))
    assert dg.shape == (len(o), 1) and ng.shape == (len(o), 3)
    assert (hg == hc).mean() > 0.93
    m = hc & hg & (dc > 0.05)
    if m.any():
        assert np.abs(dg[:, 0][m] - dc[m]).mean() < 0.02
        assert np.sum(ng[m] * nc[m], -1).mean() > 0.9


def test_rays_from_outside_hit_the_sphere(tracer):
    """Rays aimed at the centre from radius 0.9 hit at depth 0.4 with an
    inward normal (the BVH winding convention)."""
    rng = np.random.RandomState(1)
    p = rng.normal(size=(512, 3))
    p /= np.linalg.norm(p, axis=-1, keepdims=True)
    o, d = (p * 0.9).astype(np.float32), (-p).astype(np.float32)
    _, normal, depth, hit = (x.numpy() for x in tracer.trace(torch.from_numpy(o),
                                                            torch.from_numpy(d)))
    assert hit.all()
    assert np.abs(depth[:, 0] - 0.4).max() < 0.03
    assert np.sum(normal * d, -1).mean() > 0.95


def test_miss_semantics(tracer):
    o = torch.tensor([[0.0, 0.0, 0.52]])
    d = torch.tensor([[0.0, 0.0, 1.0]])
    _, normal, depth, hit = tracer.trace(o, d)
    assert not hit[0]
    assert depth[0, 0] == tracer.far
    assert (normal[0] == 0).all()
    assert not depth.requires_grad and not normal.requires_grad


def test_neural_trace_matches_jax_fused_interpret(tracer):
    """The distilled weights bridged to nero_tpu: its fused sphere-march path
    (Pallas interpret mode) and the port's give the same hits (> 0.99), the
    same depth (median |dt| < 1e-3) and the same normals on rays both hit."""
    pj = jax.tree_util.tree_map(jnp.asarray, to_numpy_tree(tracer.field_params))
    packed_j = pack_jax(pj)
    o, d = _surface_rays(1024, radius=0.8, seed=2)
    d = (-o / np.linalg.norm(o, axis=-1, keepdims=True)
         + 1.2 * d).astype(np.float32)            # about half towards the sphere
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    kw = dict(n_coarse=32, n_refine=2, n_sphere=18, margin=tracer.margin, refine="illinois")
    try:
        with force_interpret():
            t_j, n_j, h_j = J.neural_trace(pj, packed_j, jnp.asarray(o), jnp.asarray(d),
                                           tracer.bound, use_fused=True, march_mode="sphere",
                                           **kw)
    finally:
        J.neural_trace.clear_cache()
    t_t, n_t, h_t = T.neural_trace(tracer.field_params, tracer.packed, torch.from_numpy(o),
                                   torch.from_numpy(d), tracer.bound, **kw)
    h_j, h_t = np.asarray(h_j), h_t.numpy()
    assert 0.2 < h_j.mean() < 1.0
    assert (h_j == h_t).mean() > 0.99
    both = h_j & h_t
    assert np.median(np.abs(np.asarray(t_j)[both] - t_t.numpy()[both])) < 1e-3
    assert np.sum(np.asarray(n_j)[both] * n_t.numpy()[both], -1).mean() > 0.999
    miss = ~h_j & ~h_t
    assert (t_t.numpy()[miss] == 10.0).all() and (n_t.numpy()[miss] == 0).all()


def test_sphere_segment_matches_jax_formula():
    rng = np.random.default_rng(5)
    o = rng.uniform(-1.5, 1.5, (512, 3)).astype(np.float32)
    d = rng.standard_normal((512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    bound, t0 = 0.9, 0.012
    b = np.sum(o * d, -1)
    disc = b * b - (np.sum(o ** 2, -1) - bound * bound)
    sq = np.sqrt(np.maximum(disc, 0.0))
    t_enter = np.maximum(-b - sq, t0)
    t_exit = np.maximum(-b + sq, t_enter + 1e-3)
    te, tx, valid = T.sphere_segment(torch.from_numpy(o), torch.from_numpy(d), bound, t0)
    np.testing.assert_allclose(te.numpy(), t_enter, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tx.numpy(), t_exit, rtol=1e-6, atol=1e-6)
    assert (valid.numpy() == ((disc > 0) & (t_exit > t_enter))).all()


def test_distill_cache_roundtrip(tmp_path, monkeypatch):
    """A second construction loads from the cache, bit-identical; the cache
    is the port's own directory, not nero_tpu's."""
    assert T.NeuralTracer.CACHE_DIR.endswith("neural_tracer_torch")
    assert T.NeuralTracer.CACHE_DIR != J.NeuralTracer.CACHE_DIR
    mesh = proc_mesh("bowl", grid=56, lo=-0.55, hi=0.55)
    monkeypatch.setattr(T.NeuralTracer, "CACHE_DIR", str(tmp_path))
    kw = dict(distill_steps=40, distill_samples=30_000, distill_batch=8192, verbose=False)
    t1 = T.NeuralTracer(mesh["vertices"], mesh["triangles"], **kw)
    t0 = time.time()
    t2 = T.NeuralTracer(mesh["vertices"], mesh["triangles"], **kw)
    assert time.time() - t0 < 15.0  # no re-distillation
    assert t2.distill_rms == t1.distill_rms
    for l1, l2 in zip(t1.field_params["layers"], t2.field_params["layers"]):
        assert torch.equal(l1["w"], l2["w"]) and torch.equal(l1["b"], l2["b"])
    assert len(list(tmp_path.glob("*.npz"))) == 1


def test_packed_from_bridged_field_matches_jax():
    """core/convert.py carries the distilled field {"layers": [{"w","b"}]}
    and the port's pack gives nero_tpu's kernel layout from it."""
    pj = J.init_field(jax.random.PRNGKey(2))
    pt = from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), requires_grad=False)
    packed_j, packed_t = pack_jax(pj), pack_field_params(pt)
    for k, v in packed_j.items():
        np.testing.assert_array_equal(np.asarray(v), packed_t[k].numpy(), err_msg=k)


@pytest.mark.parametrize("kwargs", [{"field_topology": "wide"}, {"march_mode": "uniform"}],
                         ids=["wide", "uniform"])
def test_unported_options_raise(sphere_mesh, kwargs):
    """Both options are ported now: the tracer builds, packs its field in the
    option's layout and agrees with the exact host BVH as the default does
    (> 0.93 at a 300-step field); a value that is no option still raises."""
    tracer = T.NeuralTracer(sphere_mesh["vertices"], sphere_mesh["triangles"], cache=False,
                            n_refine=8, **SMALL, **kwargs)
    assert ("w2t" in tracer.packed) == (kwargs.get("field_topology") == "wide")
    assert len(tracer.field_params["layers"]) == (3 if "field_topology" in kwargs else 4)
    assert tracer.distill_rms < 0.01, tracer.distill_rms
    o, d = _surface_rays()
    hc = tracer.trace_cpu(o, d)[3]
    hg = tracer.trace(torch.from_numpy(o), torch.from_numpy(d))[3].numpy()
    assert (hg == hc).mean() > 0.93
    # rays aimed at the centre from radius 0.9 hit at depth 0.4, inward normal
    p = np.random.RandomState(1).normal(size=(256, 3))
    p /= np.linalg.norm(p, axis=-1, keepdims=True)
    o, d = (p * 0.9).astype(np.float32), (-p).astype(np.float32)
    _, normal, depth, hit = (x.numpy() for x in tracer.trace(torch.from_numpy(o),
                                                            torch.from_numpy(d)))
    assert hit.all() and np.abs(depth[:, 0] - 0.4).max() < 0.03
    assert np.sum(normal * d, -1).mean() > 0.95
    bad = {k: "no_such_option" for k in kwargs}
    with pytest.raises(NotImplementedError):
        T.NeuralTracer(sphere_mesh["vertices"], sphere_mesh["triangles"], cache=False,
                       **SMALL, **bad)
