"""The exact-geometry tracers of the port on the CPU (geometry/grid_tracer.py
and the device traversal of geometry/bvh.py) against nero_tpu's on the same
mesh and rays, and two training steps of the Stage-II model through each of
its tracer / shader switches: `tracer: grid`, `tracer: bvh`, the uniform
march, the `wide` field and `fused_lights`."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nero_tpu.geometry import bvh_jax as JB
from nero_tpu.geometry import grid_tracer as JG
from nero_tpu_torch.geometry import bvh as TB
from nero_tpu_torch.geometry import grid_tracer as TG
from nero_tpu_torch.geometry import neural_tracer
from nero_tpu_torch.geometry.proc_mesh import proc_mesh
from nero_tpu_torch.models.material import NeROMaterialModel
from nero_tpu_torch.ops import field_fwd, lights, march, sphere_march

# one intra-op thread: the suite runs several worker processes side by side
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sphere_mesh():
    return proc_mesh("sphere", grid=48, lo=-1.0, hi=1.0)


def _surface_rays(n=1024, radius=0.5, seed=0):
    rng = np.random.RandomState(seed)
    p = rng.normal(size=(n, 3))
    p = (p / np.linalg.norm(p, axis=-1, keepdims=True) * radius).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (p + d * 1e-5).astype(np.float32), d


def _outside_rays(n=256, seed=1):
    """From z = -2 towards the object, as tests/test_geometry.py:135."""
    rng = np.random.RandomState(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = -2.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_trilerp_matches_jax():
    rng = np.random.default_rng(0)
    res = 9
    grid = rng.standard_normal(res ** 3).astype(np.float32)
    pts = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    pts[:4] = [[0, 0, 0], [1, 1, 1], [1, 0, 0.5], [0.5, 1, 0]]
    ref = np.asarray(JG._trilerp(jnp.asarray(grid), res, jnp.asarray(pts)))
    out = TG._trilerp(torch.from_numpy(grid), res, torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def grid_pair(sphere_mesh):
    v, t = sphere_mesh["vertices"], sphere_mesh["triangles"]
    return JG.GridTracer(v, t, res=64), TG.GridTracer(v, t, res=64)


def test_grid_tracer_matches_jax(grid_pair):
    """The same baked grid (same host library) and the same fixed-iteration
    march in f32: hits equal on > 0.999 of the rays (a ray that ends within
    float noise of the threshold may flip), depth to 1e-5, normals to 1e-4."""
    gj, gt = grid_pair
    np.testing.assert_array_equal(np.asarray(gj.grid_flat), gt.grid_flat.numpy())
    for o, d in (_surface_rays(), _outside_rays()):
        ij, nj, dj, hj = jax.tree_util.tree_map(np.asarray, gj.trace(jnp.asarray(o),
                                                                     jnp.asarray(d)))
        it, nt, dt, ht = (x.numpy() for x in gt.trace(torch.from_numpy(o), torch.from_numpy(d)))
        assert dt.shape == (len(o), 1) and nt.shape == (len(o), 3)
        assert (hj == ht).mean() > 0.999
        both = hj & ht
        assert both.any()
        np.testing.assert_allclose(dt[both], dj[both], atol=1e-5)
        np.testing.assert_allclose(it[both], ij[both], atol=1e-5)
        np.testing.assert_allclose(nt[both], nj[both], atol=1e-4)
        miss = ~hj & ~ht
        assert (dt[miss] == 10.0).all() and (nt[miss] == 0).all()


def test_grid_tracer_agrees_with_exact(grid_pair):
    """Bars of tests/test_grid_tracer.py against the exact host BVH: hits on
    surface rays > 0.9; on rays from outside the depth to 0.03 and the
    normals to 0.85."""
    _, gt = grid_pair
    o, d = _surface_rays()
    hc = gt.trace_cpu(o, d)[3]
    hg = gt.trace(torch.from_numpy(o), torch.from_numpy(d))[3].numpy()
    assert (hg == hc).mean() > 0.9
    o, d = _outside_rays()
    _, nc, dc, hc = gt.trace_cpu(o, d)
    _, ng, dg, hg = (x.numpy() for x in gt.trace(torch.from_numpy(o), torch.from_numpy(d)))
    assert (hg == hc).mean() > 0.9
    m = hc & hg
    assert m.sum() >= 5
    assert np.median(np.abs(dg[:, 0][m] - dc[m])) < 0.03
    assert np.sum(ng[m] * nc[m], -1).mean() > 0.85


def test_device_bvh_matches_jax_and_host(sphere_mesh):
    """The wavefront traversal against nero_tpu's (same flattened BVH, same
    arithmetic in f32) and against the host trace, with
    tests/test_geometry.py:135's bars: same hits, depth to 1e-3, normals to
    0.99."""
    v, t = sphere_mesh["vertices"], sphere_mesh["triangles"]
    rj, rt = JB.RayTracer(v, t), TB.RayTracer(v, t)
    for k in ("nodes_f", "nodes_i", "tri_data"):
        np.testing.assert_array_equal(rj._bvh_np[k], rt._bvh_np[k])
    for o, d in (_outside_rays(), _surface_rays(256)):
        ij, nj, dj, hj = jax.tree_util.tree_map(np.asarray, rj.trace(jnp.asarray(o),
                                                                     jnp.asarray(d)))
        it, nt, dt, ht = (x.numpy() for x in rt.trace(torch.from_numpy(o), torch.from_numpy(d)))
        np.testing.assert_array_equal(ht, hj)
        assert ht.any()
        np.testing.assert_allclose(dt, dj, atol=1e-5)
        np.testing.assert_allclose(nt, nj, atol=1e-5)
        np.testing.assert_allclose(it, ij, atol=1e-5)
        ic, nc, dc, hc = rt.trace_cpu(o, d)
        np.testing.assert_array_equal(ht, hc)
        np.testing.assert_allclose(dt[:, 0], dc, atol=1e-3)
        assert np.sum(nt[hc] * nc[hc], -1).min() > 0.99
        assert (dt[~hc] == 10.0).all() and (nt[~hc] == 0).all()


def test_moller_trumbore_matches_jax():
    rng = np.random.default_rng(2)
    a = [rng.standard_normal((200, 3)).astype(np.float32) for _ in range(5)]
    a[3][:3] = a[4][:3]                      # degenerate triangles: det ~ 0
    tj, hj = JB._moller_trumbore(*map(jnp.asarray, a))
    tt, ht = TB._moller_trumbore(*map(torch.from_numpy, a))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_allclose(tt.numpy()[ht.numpy()], np.asarray(tj)[np.asarray(hj)],
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the Stage-II model through every tracer / shader switch
# ---------------------------------------------------------------------------

MAT_CFG = {
    "name": "test_mat_switches",
    "network": "material",
    "database_name": "proc/sphere/32_6",
    "train_ray_num": 32,
    "test_ray_num": 128,
    "shader_cfg": {"diffuse_sample_num": 32, "specular_sample_num": 16, "human_lights": False,
                   "outer_light_version": "direction"},
    "loss": ["nerf_render", "mat_reg"],
    "val_metric": ["mat_render"],
    "key_metric_name": "psnr",
    "tracer_distill_steps": 300,
}


@pytest.fixture(scope="module")
def small_backends(tmp_path_factory):
    """Every model of this file distills small (120 k samples) into a cache
    of its own and bakes a 64^3 grid."""
    class SmallTracer(neural_tracer.NeuralTracer):
        CACHE_DIR = str(tmp_path_factory.mktemp("tracer_cache"))

        def __init__(self, vertices, triangles, **kw):
            kw.update(distill_samples=120_000, distill_batch=16384, verbose=False)
            super().__init__(vertices, triangles, **kw)

    class SmallGrid(TG.GridTracer):
        def __init__(self, vertices, triangles, **kw):
            super().__init__(vertices, triangles, res=64, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(neural_tracer, "NeuralTracer", SmallTracer)
    mp.setattr(TG, "GridTracer", SmallGrid)
    yield SmallTracer, SmallGrid
    mp.undo()


SWITCHES = {
    "grid": {"tracer": "grid"},
    "bvh": {"tracer": "bvh"},
    "uniform": {"tracer_march_mode": "uniform", "tracer_n_refine": 8},
    "wide": {"tracer_field_topology": "wide"},
    "wide_uniform": {"tracer_field_topology": "wide", "tracer_march_mode": "uniform",
                     "tracer_n_refine": 8},
    "fused_lights": {"shader_cfg": {"fused_lights": True}},
    "fused_lights_sphere_direction": {"shader_cfg": {"fused_lights": True, "human_lights": True,
                                                     "outer_light_version": "sphere_direction"}},
    "fused_lights_no_compaction": {"shader_cfg": {"fused_lights": True}, "inner_compact": "off"},
    "rms_fallback": {"tracer_rms_fallback": 1e-9},
}


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_two_training_steps(sphere_mesh, small_backends, switch):
    """Finite losses, gradients reaching both light heads, no kernel launch
    for CPU tensors, and the backend that the switch names."""
    small_tracer, small_grid = small_backends
    over = SWITCHES[switch]
    cfg = {**MAT_CFG, "mesh": sphere_mesh, **over}
    cfg["shader_cfg"] = {**MAT_CFG["shader_cfg"], **over.get("shader_cfg", {})}
    m = NeROMaterialModel(cfg, training=True, device="cpu")
    want = {"grid": small_grid, "rms_fallback": small_grid, "bvh": TB.RayTracer}
    assert type(m.ray_tracer) is want.get(switch, small_tracer)
    counters = (sphere_march.launches, march.launches, field_fwd.launches, lights.launches)
    before = [dict(c) for c in counters]
    opt = torch.optim.Adam(m.parameters(), lr=3e-4)
    for step in range(2):
        log = m.train_step(opt, step)
        assert all(math.isfinite(float(v)) for v in log.values()), log
    assert [dict(c) for c in counters] == before
    for head in ("inner_light", "outer_light"):
        g = m.params[head][0]["v"].grad
        assert g is not None and torch.isfinite(g).all()
    assert m.params["outer_light"][0]["v"].grad.abs().max() > 0
    if "fused_lights" in switch:
        assert m.mcfg.fused_lights and m.mcfg.outer_compact_frac == 0.0
        # the convex scene compacts the inner light unless told not to: the
        # fused wrapper then runs the outer head only
        assert (m.mcfg.inner_compact_frac == 0.0) == (switch == "fused_lights_no_compaction")


def test_fused_and_unfused_steps_agree(sphere_mesh, small_backends):
    """The same model, batch and rotation draws with `fused_lights` on and
    off: on the CPU both are f32, so loss and gradients agree to 1e-5."""
    cfg = {**MAT_CFG, "mesh": sphere_mesh, "inner_compact": "off"}
    m = NeROMaterialModel(cfg, training=True, device="cpu")
    batch = m.sample_batch(torch.Generator().manual_seed(3))
    out = []
    for fused in (None, True):
        m.mcfg = m.mcfg._replace(fused_lights=fused)
        loss, _ = m.loss_fn(m.params, batch, 0, torch.Generator().manual_seed(5))
        grads = torch.autograd.grad(loss, [m.params["inner_light"][0]["v"],
                                           m.params["outer_light"][3]["b"],
                                           m.params["roughness"][0]["v"]])
        out.append((loss.detach(), grads))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-5, atol=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6 * float(a.abs().max() + 1e-3))
