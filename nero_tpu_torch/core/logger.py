"""Scalar logging to {train,val}.txt in the model dir, plus a rays/sec meter."""
from __future__ import annotations

import os
import time

import torch


class Logger:
    def __init__(self, model_dir: str):
        self.model_dir = model_dir
        os.makedirs(model_dir, exist_ok=True)

    def log(self, results: dict, prefix: str, step: int, verbose: bool = False):
        msg = f"{prefix} step {step} " + " ".join(
            f"{k} {float(v):.5f}" for k, v in results.items())
        with open(os.path.join(self.model_dir, f"{prefix}.txt"), "a") as f:
            f.write(msg + "\n")
        if verbose:
            print(msg)


class RaysPerSecMeter:
    """Rays/sec measured between points where all device work is complete.

    CUDA launches are asynchronous, so `sync` first calls
    `torch.cuda.synchronize()` on the given device before reading the clock;
    a host clock without it would measure the enqueue rate."""

    def __init__(self, device: torch.device | None = None):
        self.device = device
        self._last = None
        self.rays_per_sec = 0.0
        self.step_seconds = 0.0

    def sync(self, step: int, rays_per_step: int):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if self._last is not None:
            t0, s0 = self._last
            n = step - s0
            if n > 0 and now > t0:
                self.step_seconds = (now - t0) / n
                self.rays_per_sec = rays_per_step / self.step_seconds
        self._last = (now, step)

    def reset(self):
        """Invalidate the baseline (after validation/checkpoint pauses)."""
        self._last = None
