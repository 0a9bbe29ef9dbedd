"""What a `torch.profiler` trace of a few steady steps says: device time by
kernel, the union of device activity, and the longest idle gaps by what the
host was doing meanwhile.

The counting follows nero_tpu_torch's `profile_step.py`: a device event is
a kernel or memory operation on the card, not a user annotation (whose span
would count the kernels inside it again); the port's own kernels are known
by their names in namespace `nero` or in a source's anonymous namespace.
"""
from __future__ import annotations

import bisect

import torch

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
    "field_fwd": ("field_fwd_kernel",), "march": ("march_kernel",),
}
RUNTIME_PREFIXES = ("cuda", "cu", "ProfilerStep", "[memory]")
SCAN = 64   # host ops looked at for each gap, the latest to start before its middle


def port_family(name: str) -> str | None:
    """The port's kernel family of a device kernel's name, None for any other."""
    for family, shorts in PORT_KERNELS.items():
        for short in shorts:
            if "nero::" + short in name or ("(anonymous namespace)::" + short in name
                                            and "at::" not in name):
                return family
    return None


def _is_device_work(evt) -> bool:
    return (evt.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False) and "#" not in evt.name
            and evt.time_range.end > evt.time_range.start)


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events, window: tuple) -> dict:
    """The record of a profiled span: `window` = (start, end) in the
    profiler's microseconds. Returns {"window_s", "busy_s", "kernel_s"
    {name: seconds}, "family_s" {family: seconds}, "gaps" [(seconds, what
    the host ran)]}."""
    lo, hi = window
    device, host = [], []
    for e in events:
        if _is_device_work(e):
            device.append(e)
        elif e.device_type == torch.autograd.DeviceType.CPU and not e.name.startswith(
                RUNTIME_PREFIXES):
            host.append(e)
    kernel_s, family_s, spans = {}, {}, []
    for e in device:
        a, b = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if b <= a:
            continue
        sec = (b - a) / 1e6
        kernel_s[e.name] = kernel_s.get(e.name, 0.0) + sec
        fam = port_family(e.name)
        if fam is not None:
            family_s[fam] = family_s.get(fam, 0.0) + sec
        spans.append((a, b))
    busy = _union(spans)
    edges = [lo] + [x for s in busy for x in s] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    labelled = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        best = None
        # the innermost host op that spans the middle of the gap, among the
        # last ones to start before it
        i = bisect.bisect_right(starts, mid)
        for e in reversed(host[max(0, i - SCAN):i]):
            if e.time_range.end >= mid and (best is None or e.time_range.elapsed_us()
                                            < best.time_range.elapsed_us()):
                best = e
        labelled.append(((b - a) / 1e6, best.name if best is not None else "host, between ops"))
    return {"window_s": (hi - lo) / 1e6, "busy_s": sum(b - a for a, b in busy) / 1e6,
            "kernel_s": kernel_s, "family_s": family_s, "gaps": labelled}


def breakdown(rec: dict, top: int = 10) -> dict:
    """The contract's `breakdown`: the device operations that took the most
    time, and the idle gaps summed by what the host was doing, longest first."""
    by_host = {}
    for sec, what in rec["gaps"]:
        by_host[what] = by_host.get(what, 0.0) + sec
    ops = sorted(rec["kernel_s"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}
