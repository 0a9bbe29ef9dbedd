"""Where a training step's time goes on the GPU (Stage I or Stage II).

    python -m nero_tpu_torch.profile_step [--cfg configs/shape/proc/sphere.yaml] [--steps 5]
    python -m nero_tpu_torch.profile_step --cfg configs/shape/proc/sphere_real.yaml
    python -m nero_tpu_torch.profile_step --cfg configs/shape/proc/sphere_heads.yaml
    python -m nero_tpu_torch.profile_step --cfg configs/material/proc/bowl.yaml
    python -m nero_tpu_torch.profile_step --cfg configs/material/proc/bowl_fused.yaml

(the material configs read `data/meshes/proc_bowl.ply`, which
`python -m nero_tpu_torch.geometry.proc_mesh bowl data/meshes/proc_bowl.ply` writes).

Builds the model, optimizer and schedule through `Trainer.setup()` and times
`Trainer.train_step`, the step that `run_training` takes. After a few
warm-up steps it profiles `--steps` steps with torch.profiler (CPU + CUDA
activities). Prints the device time per step of the port's kernels and of
the largest other device kernels, the host step time (clock around
synchronised steps), the device busy time per step (kernels and memory
copies; user annotations such as `Optimizer.step#...` span other kernels
and are left out) and the device's idle share, then one JSON line with
those numbers. For a material config it also times, with CUDA events, the
forward passes of the step's parts (tracer = march kernel + gradient normal,
inner / outer / human light MLPs with their encodings, or the fused light
kernel's wrapper); what is left of the busy time is the backward pass, the
BRDF arithmetic and the optimizer.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from nero_tpu_torch.core.config import load_cfg
from nero_tpu_torch.train.trainer import Trainer

PORT_KERNELS = ("sdf_grad_fwd_kernel", "sdf_bwd_sweep_kernel", "sdf_bwd_params_kernel",
                "sdf_bwd_reduce_kernel", "shader_fwd_kernel", "shader_bwd_sweep_kernel",
                "shader_bwd_params_kernel", "shader_bwd_reduce_kernel",
                "lights_fwd_kernel", "lights_bwd_sweep_kernel", "lights_bwd_params_kernel",
                "lights_bwd_reduce_kernel", "predictor_fwd_kernel",
                "predictor_bwd_sweep_kernel", "predictor_bwd_params_kernel",
                "predictor_bwd_reduce_kernel", "sdf_fwd_kernel", "sphere_march_kernel",
                "field_fwd_kernel", "march_kernel")
GEMM_MARKS = ("gemm", "cutlass", "nvjet", "cublas", "gemv")


class ForwardTimer:
    """Wraps functions with CUDA-event timers; `ms()` gives each one's
    summed device time after a synchronise."""

    def __init__(self):
        self.events: dict[str, list] = {}

    def wrap(self, name: str, fn):
        def timed(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events.setdefault(name, []).append((start, end))
            return out
        return timed

    def ms(self) -> dict:
        torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v) for k, v in self.events.items()}


def material_forward_parts(trainer, step: int, steps: int) -> dict:
    """Forward device ms per step of the Stage-II step's parts."""
    from nero_tpu_torch.fields import mc_shading

    timer = ForwardTimer()
    model = trainer.model
    names = ("get_inner_lights", "predict_outer_lights", "get_human_light", "lights_raw")
    saved = {n: getattr(mc_shading, n) for n in names}
    saved_trace = model.trace_fn
    try:
        for n in names:
            setattr(mc_shading, n, timer.wrap(n, saved[n]))
        model.trace_fn = timer.wrap("trace_fn (march + normal)", saved_trace)
        for i in range(steps):
            trainer.train_step(step + i)
    finally:
        for n in names:
            setattr(mc_shading, n, saved[n])
        model.trace_fn = saved_trace
    return {k: v / steps for k, v in timer.ms().items()}


def is_device_work(evt) -> bool:
    """A kernel or memory copy on the card, not a user annotation (whose
    span would count the kernels inside it a second time)."""
    return (evt.device_type == torch.autograd.DeviceType.CUDA and evt.self_device_time_total > 0
            and not getattr(evt, "is_user_annotation", False) and "#" not in evt.key)


def device_breakdown(trainer, step: int, steps: int) -> dict:
    """Profile `steps` training steps from `step` (CPU + CUDA activities) and
    count the device time per step: `kernels` {name: ms} (the port's under
    their short names, listed in `port_names`), `busy_ms` their sum,
    `library_gemm_ms` the library matrix products among the others."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            trainer.train_step(step + i)
        torch.cuda.synchronize()
    kernels, port_names = {}, set()
    for evt in prof.key_averages():
        if not is_device_work(evt):
            continue
        name = evt.key
        for short in PORT_KERNELS:
            # the port's kernels live in namespace nero or in a source's
            # anonymous namespace (PyTorch has anonymous-namespace kernels
            # of its own, under at::)
            if "nero::" + short in name or ("(anonymous namespace)::" + short in name
                                            and "at::" not in name):
                # the first template argument tells backward from forward
                m = re.search(re.escape(short) + r"<(true|false)", evt.key)
                name = short + (f"<{m.group(1)}>" if m else "")
                port_names.add(name)
                break
        kernels[name] = kernels.get(name, 0.0) + evt.self_device_time_total / 1e3 / steps
    gemm = sum(v for k, v in kernels.items()
               if k not in port_names and any(m in k.lower() for m in GEMM_MARKS))
    return {"kernels": kernels, "port_names": port_names, "busy_ms": sum(kernels.values()),
            "library_gemm_ms": gemm}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", default="configs/shape/proc/sphere.yaml")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    root = tempfile.mkdtemp(prefix="nero_profile_")
    try:
        cfg = load_cfg(args.cfg)
        cfg.update(model_root=root, vis_dir=root)
        trainer = Trainer(cfg, device="cuda")
        trainer.setup()
        step = 0
        for _ in range(args.warmup):
            trainer.train_step(step)
            step += 1
        torch.cuda.synchronize()

        t0 = time.perf_counter()
        for _ in range(args.steps):
            trainer.train_step(step)
            step += 1
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / args.steps * 1e3

        breakdown = device_breakdown(trainer, step, args.steps)
        step += args.steps
        parts = {}
        if cfg["network"] == "material":
            parts = material_forward_parts(trainer, step, args.steps)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    kernels, port_names = breakdown["kernels"], breakdown["port_names"]
    busy = breakdown["busy_ms"]
    print(f"card: {card}")
    print(f"host step (synchronised): {host_ms:.2f} ms; device busy per step: {busy:.2f} ms; "
          f"device idle share: {max(0.0, 1.0 - busy / host_ms):.3f}")
    port = {k: kernels[k] for k in port_names}
    for k, v in sorted(port.items(), key=lambda kv: -kv[1]):
        print(f"  {v:8.3f} ms  {k}")
    print(f"  {busy - sum(port.values()):8.3f} ms  all other device kernels, of which the largest:")
    others = sorted(((v, k) for k, v in kernels.items() if k not in port), reverse=True)[:8]
    for v, k in others:
        print(f"  {v:8.3f} ms    {k[:90]}")
    gemm = breakdown["library_gemm_ms"]
    print(f"  {gemm:8.3f} ms  of the others are library matrix products (name holds one of "
          f"{GEMM_MARKS})")
    for k, v in parts.items():
        print(f"  {v:8.3f} ms  forward of {k} (CUDA events)")
    print(json.dumps({"card": card, "cfg": args.cfg, "host_step_ms": host_ms,
                      "device_busy_ms": busy, "idle_share": max(0.0, 1.0 - busy / host_ms),
                      "port_kernels_ms": port, "library_gemm_ms": gemm,
                      "forward_parts_ms": parts}))


if __name__ == "__main__":
    main()
