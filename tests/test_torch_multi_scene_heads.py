"""The multi-scene step of `sphere_heads.yaml`'s kind (`use_fused_sdf`,
`fused_heads`) as one program on the CPU: the scene-batched value-only SDF
and predictor functions (`sdf_fwd_scenes`, `predictor_scenes`) against
`jax.vmap` of nero_tpu's Pallas kernels in interpret mode, and to the bit
against their one-scene plain versions scene by scene; the batched step's
loss and every gradient leaf against `jax.vmap` of nero_tpu's render and
losses over stacked parameters, before and in the occlusion phase; the
kernels' scene layout against the sources, the launch counters and FLOP
tallies of a launch for S scenes; and a non-CPU tensor that reaches a
batched wrapper without a library, which raises.

Bars: B6 against the Pallas kernel, B1's sdf bar (atol 5e-3, rtol 1e-2);
B8 those of tests/test_torch_predictor.py (values atol 2e-3 rtol 1e-2; the
parameter gradients' worst mean error, each leaf over its max, under 1.5x
the bf16-XLA path's + 1e-4, every leaf and x within cosine 0.99, the mean
error of x's gradient under 0.02 of its max); the step, that of
tests/test_torch_multi_scene_step.py (loss rtol 1e-4, each gradient leaf
within 1e-3 of its max or of 1e-2 of the step's largest gradient). On the
CPU nero_tpu resolves `use_fused_sdf` and `fused_heads` off
(nero_tpu/render/shape.py:179-183), so its step runs the XLA paths, and
B8's and B6's scene axis is held against the kernels at the kernel level.
Against the one-scene plain versions, equal to the bit (row counts that are
multiples of 64, as tests/test_torch_multi_scene_step.py explains)."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nero_tpu.fields.sdf import SDFConfig as JSDFConfig, init_sdf
from nero_tpu.ops.fg_lut import get_fg_lut as jax_fg_lut
from nero_tpu.ops.mlp import apply_predictor as apply_jax, hidden_dtype, init_predictor
from nero_tpu.ops.pallas.predictor_kernel import predictor_fused
from nero_tpu.ops.pallas.sdf_kernel import pack_sdf_params, sdf_fwd_fused
from nero_tpu.render import shape as J
from nero_tpu.train.losses import compute_losses as jax_compute_losses, total_loss as jax_total
from nero_tpu_torch.core import mfu
from nero_tpu_torch.core.convert import from_numpy_tree, tree_items, tree_map
from nero_tpu_torch.fields.app_shading import AppShadingConfig, heads_raw
from nero_tpu_torch.fields.sdf import SDFConfig
from nero_tpu_torch.models.multi_scene import MultiSceneShapeModel
from nero_tpu_torch.ops import cuda_build, predictor, sdf_fwd
from nero_tpu_torch.render import shape as T
from test_torch_multi_scene_step import PARITY_CFG, _scene_rays, _stack_np
from test_torch_shape_e2e import R as RAYS
from torch_csrc import source_constants

torch.set_num_threads(1)

S = 2


def _src(name: str) -> str:
    with open(f"{cuda_build.CSRC}/{name}") as f:
        return f.read()


# ---------------------------------------------------------------------------
# (a) B6 with the scene axis against jax.vmap of nero_tpu's kernel
# ---------------------------------------------------------------------------

N_PTS = 128


@pytest.fixture(scope="module")
def sdf_setup():
    params = [jax.tree_util.tree_map(np.asarray, init_sdf(jax.random.PRNGKey(3 + s), JSDFConfig()))
              for s in range(S)]
    pts = np.random.default_rng(0).uniform(-0.7, 0.7, (S, N_PTS, 3)).astype(np.float32)
    return params, _stack_np(params), pts


def test_sdf_fwd_scenes_against_vmapped_pallas_kernel(sdf_setup):
    """The stacked parameters packed and the kernel run under jax.vmap, as
    nero_tpu's vmapped step packs them (render/shape.py:226-231)."""
    _, stacked, pts = sdf_setup
    cfg = JSDFConfig()

    def kernel(p, x):
        return sdf_fwd_fused(pack_sdf_params(p, cfg), x, cfg, interpret=True)

    ref = np.asarray(jax.vmap(kernel)(jax.tree_util.tree_map(jnp.asarray, stacked),
                                      jnp.asarray(pts)))
    assert ref.shape == (S, N_PTS, 1)
    with torch.no_grad():
        out = sdf_fwd.sdf_fwd_scenes(from_numpy_tree(stacked), torch.from_numpy(pts), SDFConfig())
    assert out.shape == (S, N_PTS, 1)
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-3, rtol=1e-2)


def test_sdf_fwd_scenes_are_the_one_scene_plain_version(sdf_setup):
    """Each scene's values equal `sdf_fwd_plain` of the scene alone, also on
    flat scene-major rows with a leading shape, as the sampler passes them."""
    params, stacked, pts = sdf_setup
    p = from_numpy_tree(stacked)
    flat = torch.from_numpy(pts).reshape(S * 8, N_PTS // 8, 3)
    with torch.no_grad():
        out = sdf_fwd.sdf_fwd_scenes(p, torch.from_numpy(pts))
        out_flat = sdf_fwd.make_sdf_fwd_scenes_fn(p, S)(flat)
        for s in range(S):
            one = sdf_fwd.sdf_fwd_plain(from_numpy_tree(params[s]), torch.from_numpy(pts[s]))
            assert torch.equal(out[s], one), s
            assert torch.equal(out_flat[s * 8:(s + 1) * 8].reshape(N_PTS, 1), one), s


def test_nograd_sdf_fn_takes_the_batched_function(monkeypatch, sdf_setup):
    """With S scenes and `use_fused_sdf` the renderer's no-gradient SDF is one
    batched function for all scenes; without it, `sdf_value` scene by scene."""
    _, stacked, pts = sdf_setup
    made = []
    real = sdf_fwd.make_sdf_fwd_scenes_fn

    def recording(params, n, cfg):
        made.append(n)
        return real(params, n, cfg)

    monkeypatch.setattr(T, "make_sdf_fwd_scenes_fn", recording)
    p = {"sdf": from_numpy_tree(stacked, requires_grad=False)}
    x = torch.from_numpy(pts).reshape(S * N_PTS, 3)
    fused = T.ShapeConfig(use_fused_sdf=True)
    with torch.no_grad():
        a = T.make_nograd_sdf_fn(p, fused)(x)
        assert made == [S]
        b = T.make_nograd_sdf_fn(p, fused._replace(use_fused_sdf=False))(x)
    assert made == [S] and torch.equal(a, b)


# ---------------------------------------------------------------------------
# (b) B8 with the scene axis against jax.vmap of nero_tpu's kernel
# ---------------------------------------------------------------------------

HEADS = [(259, 1), (72, 3), (24, 4)]
N_ROWS = 320  # tests/test_torch_predictor.py's 300 rows, to a multiple of 64


def _head_setup(d_in, d_out):
    params = [jax.tree_util.tree_map(np.asarray,
                                     init_predictor(jax.random.PRNGKey(d_in + s), d_in, d_out))
              for s in range(S)]
    rng = np.random.default_rng(d_in + d_out)
    x = (rng.standard_normal((S, N_ROWS, d_in)) * 0.5).astype(np.float32)
    cot = rng.standard_normal((S, N_ROWS, d_out)).astype(np.float32)
    return params, _stack_np(params), x, cot


def _port_heads(stacked, x, cot):
    """predictor_scenes on flat scene-major rows: its output [S, n, d_out] and
    the gradients of every stacked leaf and of x [S, n, d_in]."""
    p = from_numpy_tree(stacked)
    xt = torch.from_numpy(x.reshape(S * N_ROWS, -1)).requires_grad_(True)
    out = predictor.predictor_scenes(p, xt, S)
    loss = (out * torch.from_numpy(cot.reshape(S * N_ROWS, -1))).sum()
    grads = torch.autograd.grad(loss, [v for _, v in tree_items(p)] + [xt])
    return (out.detach().reshape(S, N_ROWS, -1).numpy(),
            [g.numpy() for g in grads[:-1]] + [grads[-1].reshape(x.shape).numpy()])


def _jax_heads(kind, stacked, x, cot):
    def head(p, xx):
        if kind == "fused":
            return predictor_fused(p, xx, interpret=True)
        with hidden_dtype(jnp.bfloat16):
            return apply_jax(p, xx, activation="none")

    def loss(p, xx):
        return jnp.sum(jax.vmap(head)(p, xx) * cot)

    p = jax.tree_util.tree_map(jnp.asarray, stacked)
    out = np.asarray(jax.vmap(head)(p, jnp.asarray(x)))
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, jnp.asarray(x))
    return out, [np.asarray(a) for _, a in tree_items(gp)] + [np.asarray(gx)]


@pytest.mark.parametrize("d_in,d_out", HEADS)
def test_predictor_scenes_against_vmapped_pallas_kernel(d_in, d_out):
    _, stacked, x, cot = _head_setup(d_in, d_out)
    out, g32 = _port_heads(stacked, x, cot)
    out_k, gk = _jax_heads("fused", stacked, x, cot)
    _, gbf = _jax_heads("bf16", stacked, x, cot)
    assert out_k.shape == out.shape == (S, N_ROWS, d_out)
    np.testing.assert_allclose(out, out_k, atol=2e-3, rtol=1e-2)

    def worst_mean_rel(ga, gb, s):
        return max(float((np.abs(a[s] - b[s]) / (np.abs(a[s]).max() + 1e-8)).mean())
                   for a, b in zip(ga, gb))

    for s in range(S):  # each scene's leaves, and x's gradient, by its own max
        assert worst_mean_rel(g32[:-1], gk[:-1], s) < 1.5 * worst_mean_rel(g32[:-1], gbf[:-1],
                                                                           s) + 1e-4
        for a, b in zip(g32, gk):
            a, b = a[s].ravel(), b[s].ravel()
            assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12) > 0.99
        assert (np.abs(g32[-1][s] - gk[-1][s]) / (np.abs(g32[-1][s]).max() + 1e-8)).mean() < 0.02


@pytest.mark.parametrize("d_in,d_out", HEADS)
def test_predictor_scenes_are_the_one_scene_plain_version(d_in, d_out):
    params, stacked, x, cot = _head_setup(d_in, d_out)
    out, grads = _port_heads(stacked, x, cot)
    for s in range(S):
        p = from_numpy_tree(params[s])
        xs = torch.from_numpy(x[s]).requires_grad_(True)
        one = predictor.predictor_plain(p, xs)
        assert np.array_equal(out[s], one.detach().numpy()), s
        g1 = torch.autograd.grad((one * torch.from_numpy(cot[s])).sum(),
                                 [v for _, v in tree_items(p)] + [xs])
        for i, (a, b) in enumerate(zip(grads, g1)):
            assert np.array_equal(a[s], b.numpy()), (s, i)


def test_heads_raw_takes_one_batched_call_a_head(monkeypatch):
    """With `fused_heads` and S scenes the per-head shader calls
    `predictor_scenes` once a head (the outer head twice), each call on every
    scene's rows; without `fused_heads` the library heads run scene by scene."""
    from nero_tpu_torch.fields.app_shading import init_app_shading
    from nero_tpu_torch.ops import shader
    from nero_tpu_torch.parallel.scenes import stack_trees

    calls = []
    real = predictor.predictor_scenes

    def recording(layers, x, n):
        calls.append((x.shape[0], n))
        return real(layers, x, n)

    monkeypatch.setattr(shader, "predictor_scenes", recording)
    cfg = AppShadingConfig(fused_shader=False, fused_heads=True)
    p = stack_trees([init_app_shading(torch.Generator().manual_seed(s), cfg)
                     for s in range(S)])
    rng = np.random.default_rng(5)
    n = 64
    rows = [torch.from_numpy(rng.standard_normal((S * n, k)).astype(np.float32))
            for k in (3, 3, 3, 256)]
    with torch.no_grad():
        a = heads_raw(p, cfg, *rows, n_scenes=S)
        b = heads_raw(p, cfg._replace(fused_heads=False), *rows, n_scenes=S)
    assert calls == [(S * n, S)] * 7 and torch.equal(a, b)


# ---------------------------------------------------------------------------
# (c) the batched heads step's loss and gradients against jax.vmap of nero_tpu's
# ---------------------------------------------------------------------------

HEADS_CFG = {**PARITY_CFG, "use_fused_sdf": True,
             "shader_config": {"fused_shader": False, "fused_heads": True}}


@pytest.mark.parametrize("step", [3, 6], ids=["before_occ", "occ_phase"])
def test_batched_heads_step_matches_vmapped_jax(step):
    cfg = dict(HEADS_CFG)
    scfg_j = J.shape_config_from_dict(dict(cfg))
    # nero_tpu's own resolution off the TPU: XLA heads, sdf_value
    assert not scfg_j.use_fused_sdf and not scfg_j.shader.fused_heads
    cfgs = [{**cfg, "name": f"scene{s}"} for s in range(S)]
    params_j = jax.tree_util.tree_map(np.asarray,
                                      J.init_shape_params(jax.random.PRNGKey(0), scfg_j))
    stacked = _stack_np([params_j] * S)
    ms = MultiSceneShapeModel(cfgs, device="cpu")
    assert ms.scfg.use_fused_sdf and ms.scfg.shader.fused_heads
    rays = [_scene_rays(ms.models[s], s) for s in range(S)]
    rays_j = {k: jnp.asarray(np.stack([r[k] for r in rays])) for k in rays[0]}

    def loss_j(p, r):
        out = J.render(p, scfg_j, jnp.asarray(jax_fg_lut()), r["rays_o"], r["rays_d"],
                       r["near"], r["far"], r["human_poses"], step, key=jax.random.PRNGKey(0),
                       is_train=True, perturb_overwrite=0.0)
        out["loss_rgb"] = J.compute_rgb_loss(out["ray_rgb"], r["rgb"], "charbonier")
        return jax_total(jax_compute_losses(cfg["loss"], out, None, step, cfg))

    p_j = jax.tree_util.tree_map(jnp.asarray, stacked)
    val_j, g_j = jax.jit(jax.value_and_grad(lambda p: jnp.sum(jax.vmap(loss_j)(p, rays_j))))(p_j)
    ms.params = from_numpy_tree(stacked)
    batch = {k: torch.from_numpy(np.concatenate([r[k] for r in rays])) for k in rays[0]}
    gens = [torch.Generator().manual_seed(s) for s in range(S)]
    loss_t, totals, logs = ms.loss_fn(ms.params, batch, step, gens)
    loss_t.backward()
    for s in range(S):
        assert (float(logs[s]["loss_occ"].detach()) > 0.0) == (step >= cfg["occ_loss_step"])
    np.testing.assert_allclose(loss_t.item(), float(val_j), rtol=1e-4)
    grads_j = list(tree_items(jax.tree_util.tree_map(np.asarray, g_j)))
    got = dict(tree_items(ms.params))
    assert set(got) == {k for k, _ in grads_j}
    for s in range(S):
        floor = 1e-2 * max(np.abs(a[s]).max() for _, a in grads_j)
        for k, a in grads_j:
            b = got[k].grad
            b = np.zeros_like(a[s]) if b is None else b[s].numpy()
            scale = max(np.abs(a[s]).max(), floor)
            np.testing.assert_allclose(b / scale, a[s] / scale, atol=1e-3, err_msg=f"{k}[{s}]")


# ---------------------------------------------------------------------------
# (d) the kernels' scene layout, counters and tallies
# ---------------------------------------------------------------------------


def _c_entry_args(src: str, name: str) -> int:
    m = re.search(rf"^int {name}\(([^)]*)\)", src, re.M)
    return len([a for a in m.group(1).split(",") if a.strip()])


def test_kernel_scene_layout_mirrors_the_sources():
    f = _src("sdf_fwd.cu")
    # B6: n points a scene, its rows after the scenes before it, its weights
    # and biases the y-th set; the tile by the rule at S n points
    for stride in ("pts += blockIdx.y * (size_t)n * 3;", "out += blockIdx.y * (size_t)n;",
                   "W += blockIdx.y * (size_t)W_TOTAL;", "bias += blockIdx.y * 9 * OUTW;",
                   "sdf_fwd_tile(n * n_scenes, sms)",
                   "<<<dim3((n + P - 1) / P, n_scenes), F_THREADS"):
        assert stride in f, stride
    assert "return sdf_fwd_scenes(pts, n, 1, W, bias, beta, scale, out, stream);" in f
    p = _src("predictor.cu")
    # B8: the forward's and the sweep's rows, weights and biases a scene further on
    for stride in ("x += blockIdx.y * (size_t)n * d_in;", "W += blockIdx.y * weight_elems(di);",
                   "B += blockIdx.y * 4 * HID;"):
        assert len(re.findall(rf"^  {re.escape(stride)}$", p, re.M)) == 2, stride
    for stride in ("out += blockIdx.y * (size_t)n * d_out;",
                   "gout += blockIdx.y * (size_t)n * d_out;",
                   "if (want_dx) dx += blockIdx.y * (size_t)n * d_in;",
                   "scratch += blockIdx.y * Scratch::elems((size_t)m_rows, di);",
                   "Scratch::elems((size_t)m_rows, tab.di));",
                   "dim3(tab.n_items(), pw_chunks(m), n_scenes)",
                   "<<<dim3((n + PB - 1) / PB, n_scenes), BTHREADS",
                   "<<<dim3(m / PB, n_scenes), BTHREADS"):
        assert stride in p, stride
    # the engine: scene z's scratch and the z-th gridDim.y chunks' partials;
    # the reduction's scene blockIdx.y; B5 passes no scene stride (z = 0)
    e = _src("engine.cuh")
    for stride in ("tab.tile(blockIdx.x, scratch + blockIdx.z * scene_scratch, M)",
                   "part + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * tab.part_row()",
                   "part += (size_t)blockIdx.y * n_chunks * row;", "dW += blockIdx.y * w;",
                   "dB += blockIdx.y * (row - w);", "size_t scene_scratch = 0"):
        assert stride in e, stride
    assert "param_pass(PwTab<L>{}, scratch, m_rows, rows_per_chunk, part);" in _src("lights.cu")
    # a scene's chunks are those of its own rows: m is one scene's bwd_rows(n)
    assert "pw_chunks(bwd_rows(n))" in p and "pw_chunks(n_scenes" not in p
    # the C entries' arguments against the wrappers' typing
    assert _c_entry_args(f, "sdf_fwd_scenes") == 9
    assert _c_entry_args(p, "predictor_fwd_scenes") == 10
    assert _c_entry_args(p, "predictor_bwd_scenes") == 16
    lib = type("Lib", (), {})()
    for name in re.findall(r"^(?:int|size_t) (predictor_\w+)\(", p, re.M):
        setattr(lib, name, type("Fn", (), {})())
    predictor.type_lib(lib)
    assert len(lib.predictor_fwd_scenes.argtypes) == 10
    assert len(lib.predictor_bwd_scenes.argtypes) == 16


def test_packed_scenes_are_each_scene_packed(sdf_setup):
    params, stacked, _ = sdf_setup
    W, bias = sdf_fwd.pack_scenes(from_numpy_tree(stacked, requires_grad=False))
    total = source_constants(("sdf_grad.cu", "sdf_net.cuh"), ("W_TOTAL",))["W_TOTAL"]
    assert W.shape == (S, total) and bias.shape == (S, 9, 272)
    for s in range(S):
        w1, b1 = sdf_fwd.pack_params(from_numpy_tree(params[s], requires_grad=False))
        assert torch.equal(W[s], w1) and torch.equal(bias[s], b1)
    hp, hstacked, _, _ = _head_setup(72, 3)
    from nero_tpu_torch.ops.mlp import resolve_weight_norm
    lay = resolve_weight_norm(from_numpy_tree(hstacked, requires_grad=False))
    Wp, Bp = predictor.pack_scenes([l["w"] for l in lay], [l["b"] for l in lay])
    assert Wp.shape == (S, 80 * 256 + 2 * 256 * 256 + 256 * 16) and Bp.shape == (S, 4, 256)
    for s in range(S):
        one = resolve_weight_norm(from_numpy_tree(hp[s], requires_grad=False))
        w1, b1 = predictor.pack_weights([l["w"] for l in one], [l["b"] for l in one])
        assert torch.equal(Wp[s], w1) and torch.equal(Bp[s], b1)


class _RecordingLib:
    """A kernel library that launches nothing: it records each C call's
    arguments, answers the size queries by `sizes` and returns 0."""

    def __init__(self, sizes):
        self.sizes, self.calls = sizes, []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return self.sizes(name, args)
        return call


def test_scene_counters_and_tallies(monkeypatch):
    """A launch for S scenes counts once, under a name of its own, with the
    FLOPs of S x n rows; it is the scenes' entry with n and S (one scene: S =
    1), with buffers S times one scene's; count_flops (the trainer's FLOPs a
    step) reads it as one launch."""
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("Stream", (), {"cuda_stream": 0})())
    for mod in (sdf_fwd, predictor):
        monkeypatch.setattr(mod, "launches", dict(mod.launches))
        monkeypatch.setattr(mod, "flop_tally", dict(mod.flop_tally))
    n, scenes = 96, 3
    lib = _RecordingLib(lambda name, args: 0)
    monkeypatch.setattr(sdf_fwd, "_lib", lambda m=6: lib)
    cfg = SDFConfig()
    W, b, pts = torch.zeros(scenes, 10), torch.zeros(scenes, 9, 272), torch.zeros(scenes, n, 3)
    out, counted = mfu.count_flops(sdf_fwd._launch, W, b, pts, cfg)
    assert out.shape == (scenes, n)
    sdf_fwd._launch(W[0], b[0], pts[0], cfg)
    sdf_fwd._launch(W, b, pts[:, :0], cfg)  # no rows: no launch counted
    assert [(name, args[1:3]) for name, args in lib.calls] == [
        ("sdf_fwd_scenes", (n, scenes)), ("sdf_fwd_scenes", (n, 1)), ("sdf_fwd_scenes", (0, scenes))]
    assert sdf_fwd.launches["sdf_fwd_scenes"] == 1 == sdf_fwd.launches["sdf_fwd"]
    assert sdf_fwd.flop_tally["sdf_fwd_scenes"] == sdf_fwd.flops(scenes * n)
    assert counted["launches_by_name"] == {"sdf_fwd_scenes": 1}
    assert counted["kernels_by_name"] == {"sdf_fwd_scenes": sdf_fwd.flops(scenes * n)}
    assert sdf_fwd.counter("sdf_fwd_scenes", 8) == "sdf_fwd_scenes_m8"

    d_in, d_out, di = 72, 3, 80
    lib = _RecordingLib(lambda name, args: 64 if "elems" in name else 0)
    monkeypatch.setattr(predictor, "_lib", lambda: lib)
    x, Wp = torch.zeros(scenes, n, d_in), torch.zeros(scenes, 7)
    Bp, gout = torch.zeros(scenes, 4, 256), torch.zeros(scenes, n, d_out)
    assert predictor._fwd(x, Wp, Bp, d_out).shape == (scenes, n, d_out)
    (dx, dW, dB), counted = mfu.count_flops(predictor._bwd, x, Wp, Bp, gout)
    assert (dx.shape, dW.shape, dB.shape) == ((scenes, n, d_in), (scenes, 7), (scenes, 4, 256))
    predictor._fwd(x[0], Wp[0], Bp[0], d_out)
    launched = [(name, args[1:3]) for name, args in lib.calls if "elems" not in name]
    assert launched == [("predictor_fwd_scenes", (n, scenes)), ("predictor_bwd_scenes", (n, scenes)),
                        ("predictor_fwd_scenes", (n, 1))]
    # the backward's buffers: one scene's size, S times by the wrapper
    assert [args for name, args in lib.calls if "elems" in name] == [(n, di), (n, di)]
    sfx = f"{d_in}x{d_out}"
    for d in ("fwd", "bwd"):
        assert predictor.launches[f"predictor_{d}_scenes_{sfx}"] == 1
    assert predictor.launches[f"predictor_fwd_{sfx}"] == 1
    assert predictor.launches[f"predictor_bwd_{sfx}"] == 0
    assert predictor.flop_tally[f"predictor_bwd_scenes_{sfx}"] == predictor.flops(
        scenes * n, d_in, d_out, True)
    assert counted["launches_by_name"] == {f"predictor_bwd_scenes_{sfx}": 1}
    # every head shape of the shader has its scene counters up front
    for di_, do_ in predictor.SHADER_SHAPES:
        assert f"predictor_fwd_scenes_{di_}x{do_}" in mfu.launch_counts()
    assert "sdf_fwd_scenes" in mfu.launch_counts()
    mfu.expect_kernels({"predictor_fwd_scenes": True, "sdf_fwd_scenes": True}, "scenes")


# ---------------------------------------------------------------------------
# (e) off the CPU a batched wrapper launches its kernel or raises
# ---------------------------------------------------------------------------


def test_batched_wrappers_raise_without_a_library(monkeypatch, sdf_setup):
    """A tensor that is not on the CPU (the meta device stands in for the
    card, which this machine lacks) reaches the kernel's library; where none
    can be built the wrapper raises, and neither the plain version nor a
    one-scene launch is called."""
    def no_library(*a, **k):
        raise RuntimeError("no library")

    def never(*a, **k):
        raise AssertionError("a plain version or a one-scene wrapper was called")

    monkeypatch.setattr(cuda_build, "load", no_library)
    monkeypatch.setattr(sdf_fwd, "sdf_fwd_plain", never)
    monkeypatch.setattr(sdf_fwd, "sdf_fwd_packed", never)
    monkeypatch.setattr(predictor, "predictor_plain", never)
    monkeypatch.setattr(predictor, "predictor", never)
    meta = lambda t: t.to("meta")
    _, stacked, pts = sdf_setup
    p = tree_map(meta, from_numpy_tree(stacked, requires_grad=False))
    with pytest.raises(RuntimeError, match="no library"):
        sdf_fwd.make_sdf_fwd_scenes_fn(p, S)(torch.from_numpy(pts).to("meta"))
    _, hstacked, x, _ = _head_setup(72, 3)
    hp = tree_map(meta, from_numpy_tree(hstacked, requires_grad=False))
    with pytest.raises(RuntimeError, match="no library"):
        predictor.predictor_scenes(hp, torch.from_numpy(x.reshape(S * N_ROWS, -1)).to("meta"), S)
