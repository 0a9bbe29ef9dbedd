"""Model-FLOPs utilisation: the counterpart of nero_tpu/core/mfu.py.

The FLOPs of one step are two parts, as nero_tpu counts XLA's cost analysis
plus each Pallas kernel's closed-form count:

  * `library`: what PyTorch's own operators compute, forward and backward,
    from `torch.utils.flop_counter.FlopCounterMode` over one call (it sees
    matrix products, convolutions and attention; elementwise work is not
    counted, as XLA's analysis of nero_tpu's matmul-bound steps);
  * `kernels`: what the port's hand-written kernels compute, which no
    operator of PyTorch sees: each kernel wrapper adds its module's
    `flops(...)` at the launch's shapes to its `flop_tally` where it counts
    the launch (the counterpart of `pallas_flops_of_text`). A launch for S
    scenes of the multi-scene step counts once, under its `_scenes`
    counter, with the FLOPs of all S scenes' rows, as nero_tpu's vmapped
    pallas_call is one call.

`mfu` divides by the step time and the card's published dense bf16 peak. A
rank of a ray group counts its own step, as nero_tpu's `compiled_flops`
counts one chip's share under GSPMD.
"""
from __future__ import annotations

import importlib

import torch

# torch.cuda.get_device_name -> dense bf16 tensor-core peak, FLOP/s per card,
# from the NVIDIA H100 Tensor Core GPU data sheet (the sparse figures halved)
PEAK_BF16 = {
    "NVIDIA H100 80GB HBM3": 989.4e12,   # SXM5, at the 700 W power limit
    "NVIDIA H100 PCIe": 756.5e12,
}
CPU_NOMINAL = 1e12   # nominal, as nero_tpu's _CPU_FALLBACK: MFU on the CPU means nothing

# the modules of the kernel wrappers, each with `launches` and `flop_tally`
KERNEL_MODULES = tuple(f"nero_tpu_torch.ops.{m}" for m in (
    "sdf_grad", "shader", "sphere_march", "march", "field_fwd", "lights", "sdf_fwd",
    "predictor"))


def peak_flops_per_sec(device=None) -> float:
    """The dense bf16 peak of `device` (default: the current CUDA card);
    CPU_NOMINAL on the CPU, NaN for a card this table does not hold (no
    guess: its MFU reads NaN)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return CPU_NOMINAL
    return PEAK_BF16.get(torch.cuda.get_device_name(dev), float("nan"))


def kernel_modules() -> list:
    return [importlib.import_module(m) for m in KERNEL_MODULES]


def launch_counts() -> dict:
    """Every kernel's launch count, by counter name."""
    return {k: v for m in kernel_modules() for k, v in m.launches.items()}


def flop_counts() -> dict:
    """Every kernel's FLOP tally, by counter name."""
    return {k: v for m in kernel_modules() for k, v in m.flop_tally.items()}


def count_flops(fn, *args, **kwargs):
    """(fn's result, its FLOP breakdown) of one call of `fn`, which runs.
    The breakdown: {"library", "kernels", "total", "kernels_by_name",
    "unknown", "launches_by_name"}: "unknown" counts the launches in the
    call that added no FLOPs to their tally, "launches_by_name" the call's
    launches of each kernel."""
    from torch.utils.flop_counter import FlopCounterMode

    launches0, tally0 = launch_counts(), flop_counts()
    with FlopCounterMode(display=False) as counter:
        result = fn(*args, **kwargs)
    launches, tally = launch_counts(), flop_counts()
    by_name, launched, unknown = {}, {}, 0
    for k, n in launches.items():
        done = n - launches0.get(k, 0)
        added = tally.get(k, 0.0) - tally0.get(k, 0.0)
        if done > 0:
            launched[k] = done
        if added > 0:
            by_name[k] = added
        elif done > 0:
            unknown += done
    library = float(counter.get_total_flops())
    kernels = float(sum(by_name.values()))
    return result, {"library": library, "kernels": kernels, "total": library + kernels,
                    "kernels_by_name": by_name, "unknown": unknown, "launches_by_name": launched}


def flops_breakdown(fn, *args, **kwargs) -> dict:
    """The FLOP breakdown of one call of `fn` (`count_flops`)."""
    return count_flops(fn, *args, **kwargs)[1]


def expect_kernels(expect: dict, label: str = "", launches: dict | None = None) -> list:
    """Raise unless each kernel-name prefix of `expect` was launched (True)
    or not (False), by the launch counters (default: their values now).
    The counterpart of nero_tpu's assert_kernels: a configuration that
    should run a kernel and does not is refused before it is measured.
    Returns the names of the kernels launched."""
    launches = launch_counts() if launches is None else launches
    names = [k for k, v in launches.items() if v > 0]
    for prefix, want in expect.items():
        have = any(n.startswith(prefix) for n in names)
        if have != want:
            raise AssertionError(
                f"{label or 'configuration'}: kernel {prefix!r} launched={have}, expected "
                f"launched={want} (kernels launched: {names or 'none'})")
    return names


def mfu(flops_per_step: float, step_time_s: float, device=None) -> float:
    """FLOPs per second over the card's dense bf16 peak (0.0 without a time
    or a count)."""
    if step_time_s <= 0 or flops_per_step <= 0:
        return 0.0
    return flops_per_step / step_time_s / peak_flops_per_sec(device)
