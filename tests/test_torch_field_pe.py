"""The distilled field's kernels (B3 sphere march, B4 uniform march, B7 one
evaluation) at pe other than 6 on the CPU: nero_tpu's kernels take pe as a
static argument and pad its 3 + 6 pe channels to 48, so pe 0-7; the port's
take it as a kernel argument (csrc/field.cuh's `encode` runs pe octaves).
Their plain versions against nero_tpu's three kernels in interpret mode at
pe 0, 3 and 7 on fields fitted to a torus (tests/test_torch_march.py's
bars), both refine modes of the sphere march; the wrappers pass pe to the C
entries and count its FLOPs; pe 8 raises; and the port's NeuralTracer keeps
its pe for the march and the normal (nero_tpu's marches and differentiates
at pe 6 whatever its field's pe) and traces a small mesh at pe 3 and 7
against the exact BVH. The CUDA kernels are held against the plain versions
at pe 0, 3 and 7 on the card by chip_smoke.py's phase 11."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nero_tpu.geometry import neural_tracer as J
from nero_tpu.ops.pallas.field_kernel import field_fwd_fused, pack_field_params as pack_jax
from nero_tpu.ops.pallas.march_kernel import march_fused, sphere_march_fused
from nero_tpu_torch.core.convert import from_numpy_tree
from nero_tpu_torch.geometry import neural_tracer as T
from nero_tpu_torch.geometry.proc_mesh import proc_mesh
from nero_tpu_torch.ops import cuda_build
from nero_tpu_torch.ops import field_fwd as KF
from nero_tpu_torch.ops import march as KM
from nero_tpu_torch.ops import sphere_march as K
from torch_csrc import source_constants

torch.set_num_threads(1)

PES = (0, 3, 7)
R = 256


def _fit(pe: int):
    """(JAX packed field, port packed field) of a `std` field at `pe`
    fitted to a torus, as tests/test_torch_march.py fits pe 6."""
    def torus_sdf(p):
        q = jnp.stack([jnp.linalg.norm(p[..., :2], axis=-1) - 0.55, p[..., 2]], axis=-1)
        return jnp.linalg.norm(q, axis=-1) - 0.12

    params = J.init_field(jax.random.PRNGKey(pe), pe=pe)
    opt = optax.adam(2e-3)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, key):
        pts = jax.random.uniform(key, (4096, 3), minval=-0.9, maxval=0.9)
        loss, g = jax.value_and_grad(
            lambda p: jnp.mean((J.field_apply(p, pts, pe=pe) - torus_sdf(pts)) ** 2))(params)
        up, opt_state2 = opt.update(g, opt_state, params)
        return optax.apply_updates(params, up), opt_state2, loss

    key = jax.random.PRNGKey(3)
    for i in range(300):
        params, opt_state, loss = step(params, opt_state, jax.random.fold_in(key, i))
    assert float(loss) < 5e-3, (pe, float(loss))
    params_t = from_numpy_tree(jax.tree_util.tree_map(np.asarray, params), requires_grad=False)
    return pack_jax(params, pe=pe), K.pack_field_params(params_t, pe)


@pytest.fixture(scope="module")
def fields():
    return {pe: _fit(pe) for pe in PES}


def _rays(n=R):
    """Rays from a sphere of radius 1.4 in random directions."""
    rng = np.random.default_rng(4)
    o = rng.standard_normal((n, 3))
    o = 1.4 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (o.astype(np.float32), d.astype(np.float32), np.full(n, 0.012, np.float32),
            np.full(n, 2.8, np.float32))


def _agree(t_j, h_j, t_t, h_t):
    """tests/test_pallas_kernels.py's bars: found agreement > 0.99 and median
    |dt| < 1e-3 on rays both found."""
    t_j, h_j, t_t, h_t = np.asarray(t_j), np.asarray(h_j), t_t.numpy(), h_t.numpy()
    assert h_j.any() and not h_j.all()
    assert (h_j == h_t).mean() > 0.99
    both = h_j & h_t
    assert np.median(np.abs(t_j[both] - t_t[both])) < 1e-3
    assert np.isfinite(t_t).all()


@pytest.mark.parametrize("pe", PES)
def test_field_fwd_plain_matches_pallas(fields, pe):
    """field_fwd_fused in interpret mode: both round the products' operands
    to bf16 and sum in f32, in another order (atol 1e-3, as B7's check on
    the card); the packed layouts key by key."""
    packed_j, packed_t = fields[pe]
    for k, v in packed_j.items():
        np.testing.assert_array_equal(np.asarray(v), packed_t[k].numpy(), err_msg=k)
    x = np.random.default_rng(pe).uniform(-1, 1, (1000, 3)).astype(np.float32)
    ref = np.asarray(field_fwd_fused(packed_j, jnp.asarray(x), pe=pe, interpret=True))
    got = KF.field_fwd(packed_t, torch.from_numpy(x), pe)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3, rtol=0)


@pytest.mark.parametrize("refine,n_refine", [("illinois", 2), ("bisect", 8)])
@pytest.mark.parametrize("pe", PES)
def test_sphere_march_plain_matches_pallas(fields, pe, refine, n_refine):
    packed_j, packed_t = fields[pe]
    rays = _rays()
    kw = dict(n_sphere=16, n_refine=n_refine, refine=refine)
    t_j, h_j = sphere_march_fused(packed_j, *map(jnp.asarray, rays), pe=pe, interpret=True, **kw)
    t_t, h_t = K.sphere_march(packed_t, *map(torch.from_numpy, rays), pe=pe, **kw)
    _agree(t_j, h_j, t_t, h_t)


@pytest.mark.parametrize("pe", PES)
def test_march_plain_matches_pallas(fields, pe):
    packed_j, packed_t = fields[pe]
    rays = _rays()
    t_j, h_j = march_fused(packed_j, *map(jnp.asarray, rays), pe=pe, n_coarse=32, n_refine=8,
                           interpret=True)
    t_t, h_t = KM.march(packed_t, *map(torch.from_numpy, rays), pe=pe, n_coarse=32, n_refine=8)
    _agree(t_j, h_j, t_t, h_t)


def test_pe_8_raises(fields):
    """3 + 6 x 8 = 51 channels do not fit the kernels' 48: nero_tpu's
    pack_field_params fails, the port's raises, and the kernel launches
    refuse pe 8 or more (the plain version on the CPU takes any pe)."""
    params_j = J.init_field(jax.random.PRNGKey(0), pe=8)
    with pytest.raises(ValueError):
        pack_jax(params_j, pe=8)
    params_t = from_numpy_tree(jax.tree_util.tree_map(np.asarray, params_j),
                               requires_grad=False)
    with pytest.raises(ValueError):
        K.pack_field_params(params_t, 8)
    packed = fields[7][1]
    for pe in range(0, K.MAX_PE + 1):
        K.check_packed(packed, "std", pe, kernel=True)
    for pe in (8, 9, -1):
        with pytest.raises(NotImplementedError):
            K.check_packed(packed, "std", pe, kernel=True)
    assert K.MAX_PE == 7 and 3 + 6 * K.MAX_PE <= K.FEAT_PAD < 3 + 6 * (K.MAX_PE + 1)


def test_kernel_instances():
    """csrc/field.cuh's limits are the wrappers' (FD_MAX_PE, the shipped
    FD_PE6), and each of the three sources launches through FIELD_DISPATCH:
    `std` at pe 6 on its own instance with the octave count a constant, any
    other pe on the instance that takes it as an argument, `wide` on one."""
    c = source_constants(("field.cuh",), ("FD_MAX_PE", "FD_PE6", "FD_ANY_PE"))
    assert (c["FD_MAX_PE"], c["FD_PE6"], c["FD_ANY_PE"]) == (K.MAX_PE, K.PE, -1)
    for fn in ("sphere_march.cu", "march.cu", "field_fwd.cu"):
        with open(os.path.join(cuda_build.CSRC, fn)) as f:
            src = f.read()
        assert src.count("FIELD_DISPATCH(") == 1 and "template <bool WIDE, int PE>" in src, fn


class _Recorder:
    """A field-kernel library that launches nothing and records each C
    entry's arguments."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def entry(*args):
            self.calls[name] = args
            return 0
        return entry


@pytest.mark.parametrize("pe", PES)
def test_wrappers_pass_pe(monkeypatch, fields, pe):
    """Each launch gives the C entry its pe after `wide`, as csrc/
    sphere_march.cu, march.cu and field_fwd.cu take it, and adds flops(...)
    at that pe: (3 + 6 pe) x 128 in the first layer."""
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("Stream", (), {"cuda_stream": 0})())
    for mod in (K, KM, KF):
        monkeypatch.setattr(mod, "launches", dict(mod.launches))
        monkeypatch.setattr(mod, "flop_tally", dict(mod.flop_tally))
    lib = _Recorder()
    for mod in (K, KM, KF):
        monkeypatch.setattr(mod, "_lib", lambda: lib)
    W, Fv = K.kernel_buffers(fields[pe][1])
    rays = [K.prep(torch.from_numpy(a)) for a in _rays(64)]
    K._launch(W, Fv, False, *rays, 16, 2, True, 0.012, 0.003, 0.9, 1 / 31, 0.25, pe)
    KM._launch(W, Fv, False, *rays, 32, 8, 0.012, pe)
    KF._launch(W, Fv, False, rays[0], pe)
    assert lib.calls["sphere_march"][7:9] == (0, pe) and len(lib.calls["sphere_march"]) == 20
    assert lib.calls["march"][7:9] == (0, pe) and len(lib.calls["march"]) == 15
    assert lib.calls["field_fwd"][4:6] == (0, pe) and len(lib.calls["field_fwd"]) == 8
    per_eval = 2 * ((3 + 6 * pe) * 128 + 2 * 128 * 128 + 128)
    assert K.eval_flops("std", pe) == per_eval
    assert K.flop_tally["sphere_march"] == 64 * 18 * per_eval
    assert KM.flop_tally["march"] == 64 * 40 * per_eval
    assert KF.flop_tally["field_fwd"] == 64 * per_eval
    assert K.launches["sphere_march"] == KM.launches["march"] == KF.launches["field_fwd"] == 1


# ---------------------------------------------------------------------------
# the neural tracer at pe 3 and 7
# ---------------------------------------------------------------------------

SMALL = dict(distill_steps=300, distill_samples=60_000, distill_batch=8192, verbose=False)


def _surface_rays(n=1024, radius=0.5, seed=0):
    rng = np.random.RandomState(seed)
    p = rng.normal(size=(n, 3))
    p = (p / np.linalg.norm(p, axis=-1, keepdims=True) * radius).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (p + d * 1e-5).astype(np.float32), d


@pytest.mark.parametrize("pe", [3, 7])
def test_neural_tracer_keeps_its_pe(monkeypatch, tmp_path, pe):
    """A NeuralTracer(pe) of the sphere mesh (radius 0.5, 300 distillation
    steps): the field is (3 + 6 pe)-wide, the march gets pe (both modes) and
    the normal is the gradient of the field at that pe. Under either march,
    surface rays agree with the exact host BVH on > 0.9 of the rays
    (tests/test_torch_neural_tracer.py asks 0.93 of a 300-step field at pe
    6), and rays aimed at the centre from radius 0.9 all hit at depth 0.4
    within 0.03 with a mean inward normal cosine > 0.95, as that file asks."""
    monkeypatch.setattr(T.NeuralTracer, "CACHE_DIR", str(tmp_path))
    mesh = proc_mesh("sphere", grid=48, lo=-1.0, hi=1.0)
    tracer = T.NeuralTracer(mesh["vertices"], mesh["triangles"], pe=pe, **SMALL)
    assert tracer.pe == pe and tracer.field_params["layers"][0]["w"].shape[0] == 3 + 6 * pe
    seen = []
    for name, fn in (("sphere_march", T.sphere_march), ("march", T.march)):
        monkeypatch.setattr(T, name, lambda *a, _fn=fn, **kw: seen.append(kw["pe"]) or _fn(*a, **kw))
    o, d = _surface_rays()
    hc = tracer.trace_cpu(o, d)[3]
    p = np.random.RandomState(1).normal(size=(512, 3))
    p /= np.linalg.norm(p, axis=-1, keepdims=True)
    o_in, d_in = (p * 0.9).astype(np.float32), (-p).astype(np.float32)
    for mode in ("sphere", "uniform"):
        tracer.march_mode = mode
        hg = tracer.trace(torch.from_numpy(o), torch.from_numpy(d))[3].numpy()
        assert (hg == hc).mean() > 0.9, (mode, (hg == hc).mean())
        _, normal, depth, hit = (x.numpy() for x in tracer.trace(torch.from_numpy(o_in),
                                                                torch.from_numpy(d_in)))
        assert hit.all(), mode
        assert np.abs(depth[:, 0] - 0.4).max() < 0.03, mode
        assert np.sum(normal * d_in, -1).mean() > 0.95, mode
    assert seen == [pe] * 4
