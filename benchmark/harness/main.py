"""One run of one cell: set-up, the measured window, the traced span, the
check against the reference, the result line."""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import shutil
import sys
import tempfile
import time

from benchmark.harness import catalog

FORBIDDEN = ("jax", "jaxlib", "flax", "nero_tpu")
READ_EVERY = 20        # the loss is read back every train_log_step steps, as Trainer.run does
TRACE_LEAD, TRACE_STEPS = 2, 8


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr)
    return 2


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv, t0: float) -> int:
    args = parse(argv)
    if not os.path.isdir(os.path.join(os.path.dirname(catalog.HERE), "nero_tpu_torch")):
        return fail("the program (nero_tpu_torch/) is not in this checkout")
    w = catalog.workload(args.workload)
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the card and has no fallback")
    if torch.cuda.device_count() < w["chips"]:
        return fail(f"the cell needs {w['chips']} cards, this machine has "
                    f"{torch.cuda.device_count()}")
    result, checks = run_cell(args, w, t0, device="cuda")
    if result is None:
        return 1
    emit(result, checks)
    return 0


def emit(result: dict, checks: dict) -> None:
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r} ({c['where']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "checks": checks}))
    sys.stdout.flush()


def run_cell(args, w: dict, t0: float, device: str = "cuda", root: str = catalog.HERE,
             fault=None):
    """(result without `checks`, checks) of one run, or (None, None) if the
    run must not report. `fault`, for the harness's own tests, is called
    with the built system before the first step."""
    import torch

    from benchmark.harness import check, photos
    from benchmark.harness.program import System, data_root
    from nero_tpu_torch.core.mfu import expect_kernels, launch_counts

    cfg = catalog.config(w["config"], root)
    tmp = tempfile.mkdtemp(prefix="nero-bench-")
    cuda = device == "cuda"
    marks = [("imports", time.perf_counter())]
    if cuda:
        from nero_tpu_torch.ops import cuda_build
        # the cell's own kernels, all nvcc runs at once, into the checkout's
        # fixed build directory (a later run finds them built)
        cuda_build.build_all(tuple(cfg["sources"]))
    marks.append(("kernels built or found", time.perf_counter()))
    try:
        for scene in w["scenes"]:
            photos.ensure(scene, data_root(), device, root)
        marks.append(("photos written or found", time.perf_counter()))
        system = System(cfg, w, args.seed, tmp, device=device)
        marks.append(("program set up, weights handed", time.perf_counter()))
        if fault is not None:
            fault(system)
        step0 = w["first_step"]
        system.start_at(step0)
        before = launch_counts()
        prog = check.program_readings(system, step0)
        marks.append((f"{check.STEPS} checked steps", time.perf_counter()))
        step = step0 + check.STEPS
        for _ in range(w["warmup_steps"]):
            system.step(step)
            step += 1
        if cuda:
            torch.cuda.synchronize()
        gate_launches(w.get("launches_per_step", cfg.get("launches_per_step", {})), before,
                      launch_counts(), step - step0, expect_kernels, device)
        setup_s = time.perf_counter() - t0
        marks.append((f"{w['warmup_steps']} warm-up steps", time.perf_counter()))
        print("set-up: " + ", ".join(f"{name} {b - a:.2f} s" for (_, a), (name, b)
                                     in zip([("start", t0)] + marks, marks)), file=sys.stderr)
        cpu0 = time.process_time()
        n, window_s, failed, host_s, ends = window(system, step, args.seconds, bool(args.trace),
                                                   cuda)
        # CPU seconds near the window's: the process was not kept waiting for a core
        print(f"host: window {window_s:.2f} s, this process's CPU "
              f"{time.process_time() - cpu0:.2f} s", file=sys.stderr)
        step += n
        rays_per_s = n * system.rays_per_step / window_s
        rec = None
        if args.trace and cuda:
            rec = traced_span(system, step)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        found = forbidden_modules()
        if found:
            print(f"benchmark: the run loaded {found}", file=sys.stderr)
            return None, None
        scenes = [system.scene_data(s) for s in range(len(system.scenes))]
        system.close()
        del system
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        refs = check.reference_readings(cfg, prog["inputs"], scenes, device=device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    numbers = check.compare(prog, refs, check.occ_phase(cfg, w["first_step"]))
    limits = w["limits"]
    checks = {k: {"value": numbers[k][0], "limit": limits[k], "where": numbers[k][1]}
              for k in limits}
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": w["chips"],
           "memory_peak_bytes": peak}
    result = {"correct": check.verdict(numbers, limits), "attempted": n, "failed": failed,
              "device": dev}
    if args.trace:
        record = {"trace": rec, "kind": kind, "work": w["work"], "window_steps": n,
                  "window_s": window_s, "step_period_s": window_s / n, "host_step_s": host_s,
                  "step_intervals_s": [(b - a) for a, b in zip(ends, ends[1:])]}
        result["metrics"] = per_layer(record, root)
        if rec is not None:
            dev.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
            from benchmark.harness.trace import breakdown
            result["breakdown"] = breakdown(rec)
    else:
        result["metrics"] = {"train_rays_per_s": {"value": rays_per_s, "unit": "rays/s"},
                             "setup_s": {"value": setup_s, "unit": "s"}}
    result = {k: result[k] for k in ("correct", "attempted", "failed", "metrics", "device",
                                     "breakdown") if k in result}
    return result, checks


def gate_launches(expect: dict, before: dict, after: dict, steps: int, expect_kernels,
                  device) -> None:
    """Refuse a run whose steps did not launch each expected kernel exactly
    so many times a step, or launched another: the cell has fallen back to
    another path. On the CPU no kernel launches."""
    if device != "cuda":
        expect = {}
    done = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    done = {k: v for k, v in done.items() if v}
    want = {k: v * steps for k, v in expect.items()}
    if done != want:
        raise SystemExit(f"launches in {steps} steps: {done}, expected {want}")
    expect_kernels({k: True for k in expect}, "benchmark cell", launches=done or {})


def window(system, step: int, seconds: float, trace: bool, cuda: bool):
    """Steps back to back for `seconds`, each loss read back every
    READ_EVERY steps; the window closes when the card has finished them.
    Returns (steps, seconds, failed steps, host seconds of each call, the
    step-end events' times in seconds)."""
    import torch

    host, events, n, bad_from = [], [], 0, None
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    start = time.perf_counter()
    while True:
        h = time.perf_counter()
        log = system.step(step + n)
        if trace:
            host.append(time.perf_counter() - h)
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
        n += 1
        if n % READ_EVERY == 0:
            losses = [float(v) for lg in system.scene_logs(log) for v in lg.values()]
            if bad_from is None and not all(math.isfinite(x) for x in losses):
                bad_from = n - READ_EVERY
        if time.perf_counter() - start >= seconds:
            break
    sync()
    window_s = time.perf_counter() - start
    ends = [0.0] + [events[0].elapsed_time(e) / 1e3 for e in events[1:]] if events else []
    return n, window_s, 0 if bad_from is None else n - bad_from, host, ends


def traced_span(system, step: int) -> dict:
    """torch.profiler over TRACE_STEPS steady steps (after TRACE_LEAD steps
    that fill the queue), reduced by benchmark/harness/trace.py."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.harness.trace import reduce

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(TRACE_LEAD):
            system.step(step + i)
        with record_function("benchmark.traced_span"):
            for i in range(TRACE_LEAD, TRACE_LEAD + TRACE_STEPS):
                system.step(step + i)
            torch.cuda.synchronize()
    events = prof.events()
    span = next(e for e in events if e.name == "benchmark.traced_span"
                and e.device_type == torch.autograd.DeviceType.CPU)
    rec = reduce(events, (span.time_range.start, span.time_range.end))
    rec["steps"] = TRACE_STEPS
    return rec


def per_layer(record: dict, root: str) -> dict:
    """Every metric file's reading of this run's record; a metric that finds
    nothing to read is left out."""
    out = {}
    for name, mod in catalog.metrics(root).items():
        v = mod.read(record)
        if v is not None:
            out[name] = {"value": v, "unit": mod.UNIT}
    return out


