"""Host spans of the training step, on the profiler's clock.

`span(name)`, or the decorator `traced(name)`, marks a layer boundary (the
names are listed in README.md's profiling paragraph; every one starts with
`nero.`). Tracing is on exactly while a `torch.profiler` is active: the
profiler that a trainer's `profile_dir` or a traced benchmark run starts is
the switch, and there is no other. Off, `span` hands back one preallocated
object that does nothing: no `record_function`, no clock, no allocation, no
synchronisation. On, the span enters `record_function(name)`, so it stands
in the profiler's trace on the kernels' clock, and is kept in memory until
`clear()` with its parent, its thread and its start and end
(`time.perf_counter_ns`).

A span's parent is the innermost open span of its own thread. A span opened
on a thread that has none open hangs under the innermost open span of the
thread that has: during `loss.backward()` on the card, the kernels' backward
wrappers and any recompute run on autograd's device thread while the step's
thread waits inside `nero.step.backward`.

`summary()` gives each name's calls and inclusive and self seconds (self:
the span's time less the part its children cover). `profile_table(events)`
gives the same from a profiler's own events, per `nero.step`, with the aten
operators each span dispatched and the device's idle time attributed to the
span the step's thread was in; `is_device_work` and `port_kernel` are the
device counting it shares with `profile_step.py`.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import re
import threading
import time

import torch
from torch.autograd.profiler import record_function

PREFIX = "nero."
STEP = "nero.step"

# the port's device kernels by family (the `nero.kernel.<family>.*` spans):
# namespace nero or a source's anonymous namespace (PyTorch has
# anonymous-namespace kernels of its own, under at::)
PORT_KERNELS = {
    "sdf_grad": ("sdf_grad_fwd_kernel", "sdf_bwd_sweep_kernel", "sdf_bwd_params_kernel",
                 "sdf_bwd_reduce_kernel"),
    "shader": ("shader_fwd_kernel", "shader_bwd_sweep_kernel", "shader_bwd_params_kernel",
               "shader_bwd_reduce_kernel"),
    "lights": ("lights_fwd_kernel", "lights_bwd_sweep_kernel", "lights_bwd_params_kernel",
               "lights_bwd_reduce_kernel"),
    "predictor": ("predictor_fwd_kernel", "predictor_bwd_sweep_kernel",
                  "predictor_bwd_params_kernel", "predictor_bwd_reduce_kernel"),
    "sdf_fwd": ("sdf_fwd_kernel",), "sphere_march": ("sphere_march_kernel",),
    "march": ("march_kernel",), "field_fwd": ("field_fwd_kernel",),
}

_clock = time.perf_counter_ns
_records: list = []     # the spans closed since clear()
_stacks: dict = {}      # thread ident -> its open spans, innermost last


_OFF = contextlib.nullcontext()   # the span of every name while no profiler runs


class Span:
    """One span: `name`, `parent` (the enclosing Span or None), `thread`,
    `start_ns`, `end_ns`."""

    __slots__ = ("name", "parent", "thread", "start_ns", "end_ns", "_rf")

    def __init__(self, name: str, parent=None, thread=None, start_ns=0, end_ns=0):
        self.name, self.parent, self.thread = name, parent, thread
        self.start_ns, self.end_ns = start_ns, end_ns

    def __enter__(self):
        tid = threading.get_ident()
        stack = _stacks.get(tid)
        if stack:
            self.parent = stack[-1]
        else:
            self.parent = next((s[-1] for s in list(_stacks.values()) if s), None)
            stack = _stacks[tid] = []
        self.thread = tid
        stack.append(self)
        self._rf = record_function(self.name)
        self._rf.__enter__()
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc):
        self.end_ns = _clock()
        self._rf.__exit__(*exc)
        stack = _stacks[self.thread]
        stack.pop()
        if not stack:
            del _stacks[self.thread]
        _records.append(self)
        return False


_profiling = torch._C._autograd._profiler_enabled   # the switch


def span(name: str):
    """A context manager marking `name` while a profiler is active; a no-op
    otherwise."""
    if not _profiling():
        return _OFF
    return Span(name)


def traced(name: str):
    """A decorator: each call of the function inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiling():
                return fn(*args, **kwargs)
            with Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def clear() -> None:
    """Forget the spans closed so far."""
    _records.clear()


def _covered(intervals, lo, hi) -> float:
    """The length of [lo, hi] that the union of `intervals` covers."""
    total, reach = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, reach), min(b, hi)
        if b > a:
            total += b - a
            reach = b
    return total


def _times(spans) -> dict:
    """{name: [calls, inclusive, self]} in the spans' own unit."""
    cover = {}
    for s in spans:
        if s.parent is not None:
            cover.setdefault(id(s.parent), []).append((s.start_ns, s.end_ns))
    out = {}
    for s in spans:
        dur = s.end_ns - s.start_ns
        row = out.setdefault(s.name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += dur
        row[2] += dur - _covered(cover.get(id(s), ()), s.start_ns, s.end_ns)
    return out


def summary() -> dict:
    """The spans closed since `clear()`: {"steps": the `nero.step` spans,
    "spans": {name: {"calls", "inclusive_s", "self_s"}}}."""
    table = _times(list(_records))
    return {"steps": table.get(STEP, [0])[0],
            "spans": {k: {"calls": c, "inclusive_s": i / 1e9, "self_s": s / 1e9}
                      for k, (c, i, s) in table.items()}}


# ---------------------------------------------------------------------------
# a profiler's events
# ---------------------------------------------------------------------------


def port_kernel(name: str) -> tuple[str, str] | None:
    """(family, short name) of one of the port's device kernels, the first
    template argument kept where it tells backward from forward; None for
    any other kernel."""
    for family, shorts in PORT_KERNELS.items():
        for short in shorts:
            if "nero::" + short in name or ("(anonymous namespace)::" + short in name
                                            and "at::" not in name):
                m = re.search(re.escape(short) + r"<(true|false)", name)
                return family, short + (f"<{m.group(1)}>" if m else "")
    return None


def is_device_work(evt) -> bool:
    """A kernel or memory operation on the card, not a user annotation (whose
    span would count the kernels inside it a second time): flagged as one, or
    named as the optimizer's are (`Optimizer.step#Adam.step`). A kernel's own
    name may hold a `#` (`{lambda(float)#1}`), always inside parentheses."""
    name = evt.name
    return (evt.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False)
            and not ("#" in name and "(" not in name)
            and evt.time_range.end > evt.time_range.start)


class _Thread:
    """One thread's spans in start order, for the innermost one open at a time."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))
        self.starts = [s.start_ns for s in self.spans]

    def innermost(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0:
            if self.spans[i].end_ns >= t:
                return self.spans[i]
            i -= 1
        return None


def _nest(events) -> tuple[list, dict, object]:
    """Span nodes of a profiler's `nero.` events with their parents (the
    rule of `Span`), {thread: _Thread} and the step's thread."""
    by_thread = {}
    for e in events:
        by_thread.setdefault(e.thread, []).append(
            Span(e.name, None, e.thread, e.time_range.start * 1e3, e.time_range.end * 1e3))
    threads = {t: _Thread(v) for t, v in by_thread.items()}
    for th in threads.values():
        stack = []
        for s in th.spans:
            while stack and stack[-1].end_ns <= s.start_ns:
                stack.pop()
            s.parent = stack[-1] if stack else None
            stack.append(s)
    main = next((s.thread for s in sorted((s for th in threads.values() for s in th.spans),
                                          key=lambda s: s.start_ns) if s.name == STEP), None)
    nodes = [s for th in threads.values() for s in th.spans]
    for s in nodes:
        if s.parent is None and s.thread != main and main is not None:
            s.parent = threads[main].innermost(s.start_ns)
    return nodes, threads, main


def profile_table(events) -> dict:
    """The span table of a profiler's events (`prof.events()`), every number
    a `nero.step`'s: {"steps", "window_ms" (the first step's start to the
    last one's end), "busy_ms" (the union of device work in it), "idle_ms",
    "outside_idle_ms" (idle while the step's thread was in no span), "spans":
    {name: {"calls", "inclusive_ms", "self_ms", "aten_ops", "idle_ms"}}}.
    `aten_ops` counts the outermost aten operators whose innermost enclosing
    span is this one (on the thread's own spans, else by the parent rule);
    `idle_ms` sums each gap in the device's activity whose middle falls in
    this span as the innermost open on the step's thread."""
    cpu = torch.autograd.DeviceType.CPU
    spans, ops, busy = [], [], []
    for e in events:
        if e.device_type == cpu:
            if e.name.startswith(PREFIX):
                spans.append(e)
            elif e.name.startswith("aten::") and not (
                    e.cpu_parent is not None and e.cpu_parent.name.startswith("aten::")):
                ops.append(e)
        elif is_device_work(e):
            busy.append((e.time_range.start * 1e3, e.time_range.end * 1e3))
    nodes, threads, main = _nest(spans)
    steps = [s for s in nodes if s.name == STEP]
    out = {"steps": len(steps), "window_ms": 0.0, "busy_ms": 0.0, "idle_ms": 0.0,
           "outside_idle_ms": 0.0, "spans": {}}
    if not steps:
        return out
    n = len(steps)
    rows = {k: {"calls": c / n, "inclusive_ms": i / 1e6 / n, "self_ms": s / 1e6 / n,
                "aten_ops": 0.0, "idle_ms": 0.0} for k, (c, i, s) in _times(nodes).items()}
    for e in ops:
        t = e.time_range.start * 1e3
        th = threads.get(e.thread)
        s = th.innermost(t) if th is not None else None
        if s is None and e.thread != main:
            s = threads[main].innermost(t)
        if s is not None:
            rows[s.name]["aten_ops"] += 1 / n
    lo, hi = min(s.start_ns for s in steps), max(s.end_ns for s in steps)
    edges, reach = [], lo
    for a, b in sorted(busy):
        if b <= reach or a >= hi:
            continue
        a, b = max(a, reach), min(b, hi)
        if a > reach:
            edges.append((reach, a))
        reach = max(reach, b)
    if hi > reach:
        edges.append((reach, hi))
    busy_ns = (hi - lo) - sum(b - a for a, b in edges)
    for a, b in edges:
        s = threads[main].innermost(0.5 * (a + b))
        if s is None:
            out["outside_idle_ms"] += (b - a) / 1e6 / n
        else:
            rows[s.name]["idle_ms"] += (b - a) / 1e6 / n
    out.update(window_ms=(hi - lo) / 1e6 / n, busy_ms=busy_ns / 1e6 / n,
               idle_ms=sum(b - a for a, b in edges) / 1e6 / n, spans=rows)
    return out
