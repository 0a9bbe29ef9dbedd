"""The Stage-I training step as one CUDA graph, captured once per step
structure and replayed.

On an H100 a one-scene step's device work is ~23 ms, while the host takes
55-60 ms to dispatch it: ~3,300 operators, each through Python, autograd and
ATen. Every step of one phase runs the same operators on the same shapes,
so `StepGraph` captures the work before the update (ray sampling, render,
losses, `loss.backward()`) as a CUDA graph and replays it: one graph launch
a step. The optimizer's update, the schedule and the log stay outside.

What changes from step to step without changing the program (the anneal
ratio, the eikonal ramp, the init-SDF anneal) reaches the step's work as
0-d f32 tensors, in every step: written before each replay into the key's
device vector from the Python numbers of the step (models/shape.py::
step_scalars), or made afresh in an eager step. The step number itself is
read only for what chooses another program (the occlusion phase, inv_s
frozen, the init-SDF term): that is the graph's key (models/shape.py::
step_key), and each key gets its own graph. At a new key

1. the first step runs eagerly on a side stream (PyTorch's warm-up before a
   capture),
2. the next step captures the work and replays it once,
3. every later step replays it,

so every step trains exactly once. A graph is dropped, and the next step
warms up again, at a key change, or when a leaf of the optimizer has moved
to other storage or lost the gradient buffer the graph writes. A profiler
started after the capture sees the replayed kernels by name (CUPTI reports
a graph's kernel nodes), so it needs no capture of its own.

Nothing in the captured work may read the device back to the host: the
renderer's compositing takes a cumulative product whose backward has no
such read (render/shape.py::_CumprodOfNonzero).

* Random draws: every generator of the step is registered with the graph;
  the capture advances none, each replay advances each as an eager step.
* Gradients: set to None before the capture only. While a graph lives the
  leaves' `.grad` are its buffers, rewritten by each replay and read by the
  optimizer outside it.
* The log: the graph's outputs are cloned after each replay, so a log
  returned earlier is never overwritten.
* Kernel counters: each kernel module counts a launch and its FLOPs on the
  host (`launches`, `flop_tally`; core/mfu.py). The capture launches nothing,
  so what it counted is taken back, and added at every replay.

Where the graph cannot hold the step (`ineligible_reason`: not a CUDA
device, a ray group whose all-reduce runs in the step, a shader recomputed
in the backward) the step runs eagerly as it always has. `counts` holds how
often each path ran.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_map

from nero_tpu_torch.core.trace import span
from nero_tpu_torch.ops.mlp import current_precision

WARMUP = "warmup"   # the eager step that opens a key


def ineligible_reason(device, group, scfg) -> str | None:
    """Why a model's step cannot be captured, None if it can: the graph
    needs a CUDA device, no ray group (its NCCL all-reduce stays eager) and
    no shader recomputed in the backward (`remat_shader`)."""
    if torch.device(device).type != "cuda":
        return "not_cuda"
    if group is not None:
        return "ray_group"
    if scfg.remat_shader:
        return "remat_shader"
    return None


# ---------------------------------------------------------------------------
# the kernel modules' host counters
# ---------------------------------------------------------------------------


def kernel_counts() -> dict:
    """A copy of every kernel module's counters: {module: (launches, flop_tally)}."""
    from nero_tpu_torch.core.mfu import kernel_modules

    return {m.__name__: (dict(m.launches), dict(m.flop_tally)) for m in kernel_modules()}


def counts_between(before: dict, after: dict) -> dict:
    """What was counted between two `kernel_counts()`, the changed entries."""
    out = {}
    for name, (launches, tally) in after.items():
        l0, t0 = before.get(name, ({}, {}))
        out[name] = ({k: v - l0.get(k, 0) for k, v in launches.items() if v != l0.get(k, 0)},
                     {k: v - t0.get(k, 0.0) for k, v in tally.items() if v != t0.get(k, 0.0)})
    return out


def set_counts(counts: dict) -> None:
    """Put every kernel module's counters back to `counts` (`kernel_counts()`)."""
    from nero_tpu_torch.core.mfu import kernel_modules

    for m in kernel_modules():
        launches, tally = counts[m.__name__]
        m.launches.clear()
        m.launches.update(launches)
        m.flop_tally.clear()
        m.flop_tally.update(tally)


def add_counts(delta: dict) -> None:
    """Add `counts_between`'s entries to the kernel modules' counters."""
    from nero_tpu_torch.core.mfu import kernel_modules

    for m in kernel_modules():
        launches, tally = delta.get(m.__name__, ({}, {}))
        for k, v in launches.items():
            m.launches[k] = m.launches.get(k, 0) + v
        for k, v in tally.items():
            m.flop_tally[k] = m.flop_tally.get(k, 0.0) + v


# ---------------------------------------------------------------------------
# the helper
# ---------------------------------------------------------------------------


def _leaves(optimizer) -> list:
    return [p for g in optimizer.param_groups for p in g["params"]]


class StepGraph:
    """One model's training steps, replayed from a CUDA graph where
    `reason` (`ineligible_reason`) is None. `generators` are the step's
    random generators. `counts`: "captures", "replays" (the capturing step's
    replay included) and "eager" steps by reason (`WARMUP` or an
    ineligibility reason)."""

    def __init__(self, device, reason: str | None, generators: list):
        self.device = torch.device(device)
        self.reason = reason
        self.generators = list(generators)
        self.counts = {"captures": 0, "replays": 0, "eager": {}}
        self._side = None
        self._drop()

    def _drop(self) -> None:
        self.key = None
        self.graph = None
        self.values = None     # the device vector of the key's per-step numbers
        self.log = None        # the graph's outputs
        self.delta = None
        self.grads = self.ptrs = ()

    def replayed_share(self) -> float:
        """Replayed steps over all steps taken (0.0 before any)."""
        total = self.counts["replays"] + sum(self.counts["eager"].values())
        return self.counts["replays"] / total if total else 0.0

    def step(self, optimizer, step: int, body, key, numbers: dict):
        """One training step: `body(step, scalars)` samples, renders and
        back-propagates and returns the log (a dict of tensors, or of such
        dicts), then the optimizer updates. `key` names the step's program,
        with the thread's storage and product contexts (ops/mlp.py);
        `numbers` are its per-step numbers ({name: Python number}), which
        `body` gets as `scalars`, 0-d f32 tensors by the same names. Returns
        the log."""
        if self.reason is not None:
            return self._eager(optimizer, step, body, numbers)
        key = (key, current_precision())
        if key != self.key or (self.graph is not None and not self._live(optimizer)):
            self._drop()
            self.key = key
            return self._warmup(optimizer, step, body, numbers)
        if self.graph is None:
            return self._capture(optimizer, step, body, numbers)
        return self._replay(optimizer, numbers)

    def _live(self, optimizer) -> bool:
        """The captured leaves hold the storage and the gradient buffers the
        graph was captured with."""
        leaves = _leaves(optimizer)
        return (len(leaves) == len(self.ptrs)
                and all(p.data_ptr() == ptr and p.grad is g
                        for p, ptr, g in zip(leaves, self.ptrs, self.grads)))

    def _tally(self, reason: str) -> None:
        eager = self.counts["eager"]
        eager[reason] = eager.get(reason, 0) + 1

    def _scalars(self, numbers: dict, static: bool) -> dict:
        """The step's numbers as 0-d f32 tensors on the device: views of the
        key's vector where `static` (rewritten before every step of the key,
        on the current stream behind every step queued before it), else of
        a fresh one."""
        host = torch.tensor([float(v) for v in numbers.values()], dtype=torch.float32)
        if not static:
            values = host.to(self.device)
        else:
            if self.values is None:
                self.values = torch.empty(len(numbers), dtype=torch.float32, device=self.device)
            # a pinned source: the copy is queued, and the block is not
            # reused before the copy has run
            self.values.copy_(host.pin_memory(), non_blocking=True)
            values = self.values
        return {k: values[i] for i, k in enumerate(numbers)}

    def _eager(self, optimizer, step, body, numbers):
        self._tally(self.reason)
        with span("nero.step.optimizer"):
            optimizer.zero_grad(set_to_none=True)
        log = body(step, self._scalars(numbers, static=False))
        with span("nero.step.optimizer"):
            optimizer.step()
        return log

    def _warmup(self, optimizer, step, body, numbers):
        self._tally(WARMUP)
        scalars = self._scalars(numbers, static=True)
        with span("nero.step.optimizer"):
            optimizer.zero_grad(set_to_none=True)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        here = torch.cuda.current_stream(self.device)
        self._side.wait_stream(here)
        with torch.cuda.stream(self._side):
            log = body(step, scalars)
        here.wait_stream(self._side)
        with span("nero.step.optimizer"):
            optimizer.step()
        return log

    def _capture(self, optimizer, step, body, numbers):
        scalars = self._scalars(numbers, static=True)
        with span("nero.step.optimizer"):
            optimizer.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = kernel_counts()
        with torch.cuda.graph(graph):
            log = body(step, scalars)
        after = kernel_counts()
        set_counts(before)   # the capture ran no kernel
        leaves = _leaves(optimizer)
        self.graph, self.log, self.delta = graph, log, counts_between(before, after)
        self.grads = [p.grad for p in leaves]
        self.ptrs = [p.data_ptr() for p in leaves]
        self.counts["captures"] += 1
        return self._replay(optimizer, numbers)

    def _replay(self, optimizer, numbers):
        with span("nero.step.graph"):
            self._scalars(numbers, static=True)
            self.graph.replay()
            add_counts(self.delta)
            log = tree_map(torch.clone, self.log)
        self.counts["replays"] += 1
        with span("nero.step.optimizer"):
            optimizer.step()
        return log
