"""The port's spans (nero_tpu_torch/core/trace.py): off without a profiler,
the Stage-I step's tree under one, the same tree in the profiler's events,
self times that add up, and the idle-by-span attribution of a profiler's
events. On the CPU through the plain paths (no JAX imported: the card's
test runs here too); the card's test holds every port kernel's launch to
its span and the trainer's idle attribution to the trace's idle time."""
import json
import threading
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nero_tpu_torch.core import trace
from nero_tpu_torch.models.multi_scene import MultiSceneShapeModel
from nero_tpu_torch.models.shape import NeROShapeModel

torch.set_num_threads(1)

TINY = {
    "name": "trace_tiny", "network": "shape", "database_name": "proc/sphere/32_6",
    "n_samples": 8, "n_importance": 8, "up_sample_steps": 2, "n_bg_samples": 4,
    "train_ray_num": 16, "test_ray_num": 64, "occ_loss_step": 2, "occ_loss_max_pn": 32,
    "anneal_end": 100, "loss": ["nerf_render", "eikonal", "std", "init_sdf_reg", "occ"],
    "eikonal_weight": 0.1, "key_metric_name": "psnr",
}
STEP_CHILDREN = ("nero.step.sample_rays", "nero.step.forward", "nero.step.optimizer",
                 "nero.step.backward", "nero.step.log")
FORWARD_CHILDREN = ("nero.render.sampler", "nero.render.background", "nero.render.sdf",
                    "nero.render.shader", "nero.render.occ", "nero.step.losses")


def _model(scenes: int, **over):
    if scenes == 1:
        m = NeROShapeModel({**TINY, **over}, device="cpu")
    else:
        m = MultiSceneShapeModel([{**TINY, "name": f"s{s}", **over} for s in range(scenes)],
                                 device="cpu")
    return m, torch.optim.Adam(m.parameters(), lr=1e-3)


def _profiled(model, opt, steps: int, first: int = 3):
    """The in-memory spans and the profiler's events of `steps` steps."""
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(steps):
            model.train_step(opt, first + i)
    return list(trace._records), prof.events()


@pytest.fixture(scope="module", params=[1, 2], ids=["one_scene", "scenes2"])
def traced(request):
    model, opt = _model(request.param)
    return _profiled(model, opt, 2)


def _parent(s):
    return None if s.parent is None else s.parent.name


def test_no_profiler_records_nothing(monkeypatch):
    """Off: one preallocated no-op, no record_function, no clock, no
    synchronisation, nothing kept."""
    def boom(*a, **k):
        raise AssertionError("called with tracing off")

    model, opt = _model(1)
    monkeypatch.setattr(trace, "record_function", boom)
    monkeypatch.setattr(trace, "_clock", boom)
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    trace.clear()
    model.train_step(opt, 3)
    assert trace.summary() == {"steps": 0, "spans": {}}
    assert trace.span("nero.a") is trace.span("nero.b")


def test_a_span_synchronises_nothing_when_on(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail("synchronised"))
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("nero.step"):
            with trace.span("nero.step.forward"):
                torch.ones(4).sum()
    assert trace.summary()["spans"]["nero.step.forward"]["calls"] == 1


def test_the_step_records_the_tree(traced):
    """One `nero.step` a step; each layer's span under its parent."""
    spans, _ = traced
    names = [s.name for s in spans]
    assert names.count("nero.step") == 2
    for s in spans:
        if s.name == "nero.step":
            assert s.parent is None
        elif s.name in STEP_CHILDREN:
            assert _parent(s) == "nero.step", s.name
        elif s.name in FORWARD_CHILDREN:
            assert _parent(s) == "nero.step.forward", s.name
    for name in STEP_CHILDREN + FORWARD_CHILDREN:
        assert name in names, name
    # zero_grad and the update: two optimizer spans a step
    assert names.count("nero.step.optimizer") == 4
    assert not [n for n in names if n.startswith("nero.kernel.")]  # the plain paths on the CPU


def test_every_span_is_a_profiler_event_with_its_nesting(traced):
    spans, events = traced
    mine = sorted((s.name, _parent(s)) for s in spans)
    nodes, _, _ = trace._nest([e for e in events if e.device_type == torch.autograd.DeviceType.CPU
                               and e.name.startswith(trace.PREFIX)])
    theirs = sorted((s.name, _parent(s)) for s in nodes)
    assert mine == theirs


def test_self_times_add_up(traced):
    """Every span's self time summed is the steps' time, per name each self
    time within its inclusive time."""
    trace._records[:] = traced[0]
    s = trace.summary()
    assert s["steps"] == 2
    rows = s["spans"].values()
    assert sum(r["self_s"] for r in rows) == pytest.approx(
        s["spans"]["nero.step"]["inclusive_s"], rel=1e-9)
    assert all(0 <= r["self_s"] <= r["inclusive_s"] for r in rows)
    table = trace.profile_table(traced[1])
    assert table["steps"] == 2 and set(table["spans"]) == set(s["spans"])
    assert sum(r["self_ms"] for r in table["spans"].values()) == pytest.approx(
        table["spans"]["nero.step"]["inclusive_ms"], rel=1e-6)


def test_the_recompute_in_the_backward_hangs_under_it():
    """`remat_shader` runs the shader again in loss.backward()."""
    model, opt = _model(1, remat_shader=True)
    spans, _ = _profiled(model, opt, 1)
    shader = [_parent(s) for s in spans if s.name == "nero.render.shader"]
    assert sorted(shader) == ["nero.step.backward", "nero.step.forward"]


def test_a_span_of_another_thread_hangs_under_the_open_one():
    """Autograd's device thread: a span opened on a thread with none open
    takes the innermost open span of the thread that waits (entered here
    directly: a plain thread does not see the profiler's switch)."""
    trace.clear()
    seen = {}

    def device_thread():
        with trace.Span("nero.kernel.sdf_grad.bwd") as s:
            with trace.Span("nero.inner") as inner:
                seen.update(outer=s, inner=inner)

    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("nero.step"), trace.span("nero.step.backward") as bwd:
            t = threading.Thread(target=device_thread)
            t.start()
            t.join(timeout=60)
    assert not t.is_alive()
    assert seen["outer"].parent is bwd and seen["inner"].parent is seen["outer"]
    assert seen["outer"].thread != bwd.thread


def _evt(name, a, b, thread=1, device=False, parent=None, annotation=False):
    kind = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=a, end=b),
                                 thread=thread, device_type=kind, cpu_parent=parent,
                                 is_user_annotation=annotation)


def test_idle_time_goes_to_the_span_the_step_was_in():
    """Two steps (us); each gap of the device's activity goes to the
    innermost span open on the step's thread at its middle."""
    backward = _evt("nero.step.backward", 55, 90)
    op = _evt("aten::mm", 62, 64, thread=2)
    events = [
        _evt("nero.step", 0, 100), _evt("nero.step.forward", 10, 50), backward,
        _evt("nero.kernel.sdf_grad.bwd", 60, 70, thread=2), op,
        _evt("aten::t", 62.5, 63, thread=2, parent=op),   # inside an aten op: not counted
        _evt("aten::add", 72, 74, thread=2),               # no span of its thread: adopted
        _evt("aten::mul", 12, 13),
        _evt("nero.step", 200, 300),
        _evt("k", 0, 20, device=True), _evt("k", 30, 44, device=True),
        _evt("k", 48, 80, device=True), _evt("k", 95, 120, device=True),
        _evt("k", 150, 160, device=True),
        _evt("nero.step", 0, 300, device=True, annotation=True),  # a user annotation
        _evt("Optimizer.step#Adam.step", 0, 300, device=True),  # an annotation by its name
        _evt("void at::native::kernel<{lambda(float)#1}>(int)", 120, 125, device=True),
    ]
    t = trace.profile_table(events)
    sp = t["spans"]
    assert t["steps"] == 2
    # gaps 20-30 and 44-48 (forward), 80-95 (backward), 125-150 (between the
    # steps), 160-300 (the second step)
    assert t["window_ms"] == pytest.approx(0.300 / 2)
    assert t["idle_ms"] == pytest.approx(0.194 / 2)
    assert t["busy_ms"] == pytest.approx(0.106 / 2)
    assert sp["nero.step.forward"]["idle_ms"] == pytest.approx(0.014 / 2)
    assert sp["nero.step.backward"]["idle_ms"] == pytest.approx(0.015 / 2)
    assert sp["nero.step"]["idle_ms"] == pytest.approx(0.140 / 2)
    assert t["outside_idle_ms"] == pytest.approx(0.025 / 2)
    assert sp["nero.kernel.sdf_grad.bwd"]["idle_ms"] == 0
    assert (sp["nero.kernel.sdf_grad.bwd"]["aten_ops"], sp["nero.step.backward"]["aten_ops"],
            sp["nero.step.forward"]["aten_ops"]) == (0.5, 0.5, 0.5)
    # the kernel's span hangs under the backward: 35 - 10 us of self time
    assert sp["nero.step.backward"]["self_ms"] == pytest.approx(0.025 / 2)
    assert sp["nero.step"]["self_ms"] == pytest.approx((0.200 - 0.040 - 0.035) / 2)
    assert sp["nero.step"]["calls"] == 1.0 and sp["nero.step.forward"]["calls"] == 0.5


def test_port_kernels_by_family():
    assert trace.port_kernel("void nero::sdf_grad_fwd_kernel<false>(float)") == (
        "sdf_grad", "sdf_grad_fwd_kernel<false>")
    assert trace.port_kernel("(anonymous namespace)::sdf_fwd_kernel<64>(...)") == (
        "sdf_fwd", "sdf_fwd_kernel")
    assert trace.port_kernel("(anonymous namespace)::march_kernel(...)")[0] == "march"
    assert trace.port_kernel("nero::sphere_march_kernel(...)")[0] == "sphere_march"
    assert trace.port_kernel("at::(anonymous namespace)::shader_fwd_kernel") is None
    assert trace.port_kernel("ampere_sgemm_128x64_nn") is None


@pytest.mark.gpu
def test_kernel_launches_lie_in_their_spans_on_the_card(tmp_path):
    """A trainer's profiled steps in the occlusion phase on the card: each
    port kernel's launch (its runtime call, by correlation) inside a
    `nero.kernel.<family>.*` span of the launching thread, and the
    `.spans.json` attributing the window's device idle time (from the
    Chrome trace's own kernels and copies) to spans within 1%."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    from nero_tpu_torch.core.config import load_cfg
    from nero_tpu_torch.train.trainer import Trainer

    cfg = load_cfg("configs/shape/proc/sphere.yaml")
    cfg.update(model_root=str(tmp_path), vis_dir=str(tmp_path), profile_dir=str(tmp_path),
               occ_loss_step=3, total_step=9, profile_start=5, profile_steps=3,
               val_interval=100, save_interval=100)
    Trainer(cfg, device="cuda").run()
    stem = tmp_path / f"{cfg['name']}_steps5-7"
    with open(f"{stem}.trace.json") as f:
        events = json.load(f)["traceEvents"]
    with open(f"{stem}.spans.json") as f:
        table = json.load(f)
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("nero.")]
    launched = 0
    for k in events:
        port = trace.port_kernel(k.get("name", "")) if k.get("cat") == "kernel" else None
        if port is None:
            continue
        call = runtime[k["args"]["correlation"]]
        assert any(s["name"].startswith(f"nero.kernel.{port[0]}.")
                   and (s["pid"], s["tid"]) == (call["pid"], call["tid"])
                   and s["ts"] <= call["ts"] and call["ts"] + call["dur"] <= s["ts"] + s["dur"]
                   for s in spans), (k["name"], call)
        launched += 1
    assert launched >= 3 * 8   # B1 and B2: a forward and three backward kernels each
    steps = [s for s in spans if s["name"] == "nero.step"]
    lo, hi = min(s["ts"] for s in steps), max(s["ts"] + s["dur"] for s in steps)
    busy = [(max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    idle = (hi - lo) - trace._covered([(a, b) for a, b in busy if b > a], lo, hi)
    n = table["steps"]
    attributed = table["outside_idle_ms"] + sum(r["idle_ms"] for r in table["spans"].values())
    assert n == 3 and table["spans"]["nero.step"]["calls"] == 1.0
    assert attributed * n == pytest.approx(idle / 1e3, rel=0.01), (
        table["window_ms"] * n, table["busy_ms"] * n, (hi - lo) / 1e3, (hi - lo - idle) / 1e3)
    assert table["spans"]["nero.kernel.sdf_grad.bwd"]["calls"] == 1.0
