"""Training orchestration: step loop, optimizer, checkpoints, validation.

Counterpart of nero_tpu/train/trainer.py: loss = sum of every 'loss*'
output, warm-up-cosine learning rate, validation every val_interval with
best-model selection on the key metric, a checkpoint every save_interval
with auto-resume, scalar logs in the model dir and a rays/sec meter.

The optimizer is `torch.optim.Adam` over the {v, g, b} leaves, stepped
with lr(step) from `train/lr.py` through LambdaLR: this reproduces
`optax.adam(learning_rate=schedule)` (defaults b1 0.9, b2 0.999, eps 1e-8,
bias correction, eps outside the square root in both). Checkpoints are
nero_tpu's `.npz` (core/checkpoint.py): either package resumes the other's.
With `profile_dir` set it writes a torch.profiler Chrome trace of steps
[profile_start, profile_start + profile_steps) there, as nero_tpu writes its
JAX trace, and beside it `<name>_steps<a>-<b>.spans.json`: the host time,
aten operators and device idle time of each span of the step
(core/trace.py), read from the same events.

MFU (core/mfu.py), as nero_tpu logs it: the first step taken is counted
(`count_flops`: PyTorch's operators forward and backward plus the kernels'
FLOP tallies), and again the occlusion phase's first step when the run
starts before it; a counted step is left out of the rays/s meter's window.
Every `train_log_step` the log holds `mfu`, the step's FLOPs per second over
the card's dense bf16 peak (per card: a rank counts its own step).

With a ray group (`group`, parallel/mesh.py; run_training.py sets it up
under torchrun) the model trains on it, `rays_per_sec` counts the global
batch, and rank 0 alone writes logs, checkpoints and traces and runs
validation while the other ranks wait at a barrier.

`matmul_precision` (nero_tpu's names, default "default") sets the product
mode of the plain MLP layers (ops/mlp.py::product_mode) inside the
training step and the validation renders only, where nero_tpu sets JAX's
precision for the whole process: model construction, the tracer's
distillation and extraction stay f32.
"""
from __future__ import annotations

import json
import os
import random
from pathlib import Path

import numpy as np
import torch

from nero_tpu_torch.core import trace
from nero_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from nero_tpu_torch.core.device import resolve_device
from nero_tpu_torch.core.logger import Logger, RaysPerSecMeter
from nero_tpu_torch.core.mfu import count_flops, mfu
from nero_tpu_torch.models import get_model
from nero_tpu_torch.ops.mlp import product_mode, resolve_matmul_precision
from nero_tpu_torch.parallel.mesh import DataGroup
from nero_tpu_torch.train.losses import name2loss
from nero_tpu_torch.train.lr import name2lr_schedule
from nero_tpu_torch.train.metrics import name2metrics
from nero_tpu_torch.train.valid import ValidationEvaluator


def make_optimizer(params: list, optimizer_type: str, lr_schedule, device: torch.device):
    """(optimizer, LambdaLR) stepping `params` with lr(step) of `lr_schedule`."""
    if optimizer_type == "adam":
        opt_cls = torch.optim.Adam
    elif optimizer_type == "sgd":
        opt_cls = torch.optim.SGD
    else:
        raise NotImplementedError(optimizer_type)
    base = lr_schedule.base_lr
    # on the card, one fused multi-tensor update instead of one launch
    # group per parameter tensor (the same Adam arithmetic)
    kw = {"fused": True} if opt_cls is torch.optim.Adam and device.type == "cuda" else {}
    optimizer = opt_cls(params, lr=base, **kw)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer,
                                                        lambda s: lr_schedule(s) / base)


class Trainer:
    default_cfg = {
        "optimizer_type": "adam",
        "lr_type": "warm_up_cos",
        "lr_cfg": {},
        "total_step": 300000,
        "train_log_step": 20,
        "val_interval": 10000,
        "save_interval": 500,
        "random_seed": 6033,
        # products of the plain MLP layers on the card: "default" takes bf16
        # operands with f32 accumulation, "high" TF32, "highest" f32; on the
        # CPU every name computes in f32
        "matmul_precision": "default",
        "model_root": "data/model",
        "vis_dir": "data/train_vis",
        # write a torch.profiler trace of steps [profile_start, profile_start + profile_steps)
        "profile_dir": None,
        "profile_start": 20,
        "profile_steps": 5,
    }

    def __init__(self, cfg: dict, device=None, group: DataGroup | None = None):
        self.cfg = {**self.default_cfg, **cfg}
        self.device = resolve_device(device)
        self.group = group
        # rank 0 of the world writes and validates; every rank trains
        self.is_main = group is None or torch.distributed.get_rank() == 0
        # an unknown name raises before anything is written
        self.product_mode = resolve_matmul_precision(self.cfg["matmul_precision"], self.device)
        random.seed(self.cfg["random_seed"])
        np.random.seed(self.cfg["random_seed"])
        self.model_name = self.cfg["name"]
        self.model_dir = os.path.join(self.cfg["model_root"], self.model_name)
        Path(self.model_dir).mkdir(exist_ok=True, parents=True)
        self.ckpt_fn = os.path.join(self.model_dir, "model.npz")
        self.best_ckpt_fn = os.path.join(self.model_dir, "model_best.npz")
        self.train_history: list[dict] = []
        self.model = None

    def setup(self):
        """Build the model, optimizer and schedule (`run` calls it if needed)."""
        self.model = get_model(self.cfg["network"])(self.cfg, training=True, device=self.device,
                                                    group=self.group)
        self.val_losses = [name2loss[n] for n in self.cfg["loss"]]
        self.val_metrics = [name2metrics[n] if n in name2metrics else name2loss[n]
                            for n in self.cfg["val_metric"]]
        lr_cfg = dict(self.cfg.get("lr_cfg") or {})
        lr_cfg.setdefault("end_iter", self.cfg["total_step"])
        self.lr_schedule = name2lr_schedule[self.cfg["lr_type"]](lr_cfg)
        self.optimizer, self.scheduler = make_optimizer(
            self.model.parameters(), self.cfg["optimizer_type"], self.lr_schedule, self.device)
        self.val_evaluator = ValidationEvaluator(self.cfg)

    def precision(self):
        """The product context of `matmul_precision` on the trainer's device."""
        return product_mode(self.product_mode)

    def train_step(self, step: int) -> dict:
        """One optimizer step at `step`, then the schedule's step; returns
        the step's (device) log."""
        with self.precision():
            log = self.model.train_step(self.optimizer, step)
        self.scheduler.step()
        return log

    def save(self, path: str, step: int, best_para: float):
        """Checkpoint the parameters, the optimizer, the schedule's position
        and the model's batch generator after `step` steps (rank 0 writes)."""
        if self.is_main:
            save_checkpoint(path, step, best_para, self.model.params, self.optimizer,
                            self.scheduler.last_epoch, getattr(self.model, "gen", None))

    def _barrier(self):
        """Every rank waits here for rank 0's writes and validation."""
        if self.group is not None:
            torch.distributed.barrier()

    def resume(self) -> tuple[float, int]:
        """Load the checkpoint at `ckpt_fn` (the port's or nero_tpu's) into the
        model, optimizer, schedule and generator; returns (best_para, step),
        (0.0, 0) without one."""
        if not os.path.exists(self.ckpt_fn):
            return 0.0, 0
        step, best_para = load_checkpoint(self.ckpt_fn, self.model.params, self.optimizer,
                                          self.scheduler, getattr(self.model, "gen", None))
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_schedule(self.scheduler.last_epoch)
        print(f"==> resuming from step {step} best para {best_para}")
        return best_para, step

    def _start_profile(self):
        trace.clear()
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof, first: int, last: int) -> None:
        """Close the window once the device has finished its steps, as
        nero_tpu blocks on the loss, and write the Chrome trace and, beside
        it, the span table of the same events (core/trace.py::profile_table)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        Path(self.cfg["profile_dir"]).mkdir(exist_ok=True, parents=True)
        stem = os.path.join(self.cfg["profile_dir"], f"{self.model_name}_steps{first}-{last}")
        prof.export_chrome_trace(stem + ".trace.json")
        with open(stem + ".spans.json", "w") as f:
            json.dump(trace.profile_table(prof.events()), f, indent=1)
        print(f"profiler trace of steps {first}-{last}: {stem}.trace.json, spans by layer: "
              f"{stem}.spans.json")

    def _validate(self, logger, params, step: int, best_para: float) -> float:
        """Every validation set at `step`; the last one selects the best
        model. Returns the best key metric so far."""
        val_names = [vs.get("name", "val")
                     for vs in self.cfg.get("val_set_list", [{"name": "val"}])]
        all_results, val_para = {}, 0.0
        for vn in val_names:
            with self.precision():
                val_results, val_para = self.val_evaluator(
                    self.model, params, self.val_losses, self.val_metrics,
                    list(range(len(self.model.test_ids))), step, self.model_name,
                    val_set_name=vn, vis_dir=self.cfg["vis_dir"])
            for k, v in val_results.items():
                all_results[f"{vn}-{k}"] = v
        if val_para > best_para:
            print(f"New best model {self.cfg['key_metric_name']}: "
                  f"{val_para:.5f} previous {best_para:.5f}")
            best_para = val_para
            self.save(self.best_ckpt_fn, step + 1, best_para)
        self.val_results = {k: float(np.mean(v)) for k, v in all_results.items()}
        logger.log(self.val_results, "val", step + 1)
        return best_para

    def run(self):
        if self.model is None:
            self.setup()
        logger = Logger(self.model_dir)
        meter = RaysPerSecMeter(self.device)
        best_para, start_step = self.resume()
        rays_per_step = self.model.num_train_rays_per_step()
        total = self.cfg["total_step"]
        params = self.model.params
        prof = None
        prof_start = self.cfg["profile_start"]
        prof_last = min(prof_start + self.cfg["profile_steps"], total) - 1
        # the occlusion phase's steps compute more: counted again at its first
        scfg = getattr(self.model, "scfg", None)
        recount = scfg.occ_loss_step if scfg is not None and scfg.apply_occ_loss else None
        for step in range(start_step, total):
            if self.cfg["profile_dir"] and self.is_main and step == prof_start <= prof_last:
                prof = self._start_profile()
            if step == start_step or step == recount:
                # the step's FLOPs, counted at the first step of each phase the
                # run takes; a counted step stays out of the meter's window
                meter.reset()
                log, self.flops = count_flops(self.train_step, step)
                meter.sync(step + 1, rays_per_step)
            else:
                log = self.train_step(step)
            if prof is not None and step == prof_last:
                self._stop_profile(prof, prof_start, prof_last)
                prof = None

            if (step + 1) % self.cfg["train_log_step"] == 0:
                host_log = {k: float(v) for k, v in log.items()}
                meter.sync(step + 1, rays_per_step)
                host_log["lr"] = self.lr_schedule(step)
                host_log["rays_per_sec"] = meter.rays_per_sec
                host_log["step_seconds"] = meter.step_seconds
                host_log["mfu"] = mfu(self.flops["total"], meter.step_seconds, self.device)
                if self.is_main:
                    logger.log(host_log, "train", step + 1)
                self.train_history.append({"step": step, **host_log})

            if (step + 1) % self.cfg["val_interval"] == 0 or (step + 1) == total:
                if self.is_main:
                    best_para = self._validate(logger, params, step, best_para)
                self._barrier()
                meter.reset()

            if (step + 1) % self.cfg["save_interval"] == 0:
                self.save(self.ckpt_fn, step + 1, best_para)
                self._barrier()
                meter.reset()
        self.save(self.ckpt_fn, total, best_para)
        self._barrier()
        return params
