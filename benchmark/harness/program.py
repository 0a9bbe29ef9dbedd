"""The system under test: nero_tpu_torch's Stage-I trainer, built from a
configuration file and a workload file, with the benchmark's inputs in it.
Each scene's photos are the benchmark's (`photos.py`), which the program
reads as the GlossySynthetic database `syn/<scene>` under its data root.

One scene goes through `Trainer.setup()` and `Trainer.train_step(step)`,
the loop that `run_training` runs; several scenes through
`MultiSceneShapeModel.train_step(optimizer, step)` and the schedule's step,
set up as `train_multi_scene.main` sets them up, inside the product
context of the configuration's `matmul_precision` as `Trainer.train_step`
enters it. Either way the benchmark
then hands the program its weights (made on the device from the seed),
seeds each scene's batch generator, and puts the schedule at the cell's
first step, as `Trainer.resume` does.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from benchmark.harness import photos
from benchmark.harness.weights import make_params
from benchmark.reference.stage1 import tree_items

CONFIG_META = ("source", "reduced", "assumed", "precision", "sources", "launches_per_step")


def derived_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one purpose of one run, from the run's seed."""
    return int(np.random.SeedSequence([seed, *path]).generate_state(2, np.uint64)[0] >> 1)


def data_root() -> str:
    """Where the program reads its databases (NERO_TPU_DATA_ROOT)."""
    from nero_tpu_torch.dataset.database import DATA_ROOT

    return os.path.abspath(DATA_ROOT)


def run_config(config: dict, scene: str, tmp: str) -> dict:
    """The trainer's configuration: the file's keys with the scene's
    database, every output under `tmp` and no profiler of its own."""
    cfg = {k: v for k, v in config.items() if k not in CONFIG_META}
    database = f"syn/{scene}"
    cfg.update(database_name=database, model_root=tmp, vis_dir=tmp, profile_dir=None)
    cfg["train_dataset_cfg"] = {"database_name": database}
    cfg["val_set_list"] = [{"name": "val", "type": "dummy", "cfg": {"database_name": database}}]
    return cfg


class System:
    """The trainer of a workload's scenes on `device`, holding the
    benchmark's parameters and generators; `step(i)` is the timed call."""

    def __init__(self, config: dict, workload: dict, seed: int, tmp: str, device="cuda"):
        self.device = torch.device(device)
        self.scenes = list(workload["scenes"])
        cfgs = [run_config(config, db, tmp) for db in self.scenes]
        if len(cfgs) == 1:
            from nero_tpu_torch.train.trainer import Trainer

            self.trainer = Trainer(cfgs[0], device=self.device)
            self.trainer.setup()
            self.models = [self.trainer.model]
            self.params = self.trainer.model.params
            self.optimizer, self.scheduler = self.trainer.optimizer, self.trainer.scheduler
            self.lr_schedule = self.trainer.lr_schedule
        else:
            from nero_tpu_torch.models.multi_scene import MultiSceneShapeModel
            from nero_tpu_torch.ops.mlp import product_mode, resolve_matmul_precision
            from nero_tpu_torch.train.lr import name2lr_schedule
            from nero_tpu_torch.train.trainer import make_optimizer

            self.trainer = None
            self.ms = MultiSceneShapeModel(cfgs, device=self.device)
            self.models = [self.ms.models[s] for s in self.ms.scenes]
            self.params = self.ms.params
            lr_cfg = dict(cfgs[0].get("lr_cfg") or {})
            lr_cfg.setdefault("end_iter", cfgs[0]["total_step"])
            self.lr_schedule = name2lr_schedule[cfgs[0]["lr_type"]](lr_cfg)
            self.optimizer, self.scheduler = make_optimizer(self.ms.parameters(), "adam",
                                                            self.lr_schedule, self.device)
            # the products in the configuration's matmul_precision, as
            # Trainer.train_step runs them (train_multi_scene.main enters no
            # product context, so its library products run in f32)
            mode = resolve_matmul_precision(cfgs[0].get("matmul_precision", "default"),
                                            self.device)
            self.precision = lambda: product_mode(mode)
        self.rays_per_step = sum(m.num_train_rays_per_step() for m in self.models)
        self.hand_inputs(config, seed)

    def hand_inputs(self, config: dict, seed: int) -> None:
        """Copy the benchmark's weights into the program's leaves and seed
        each scene's batch generator, both from `seed`."""
        self.params0 = [make_params(config, derived_seed(seed, 1, s), self.device)
                        for s in range(len(self.scenes))]
        with torch.no_grad():
            for s, p0 in enumerate(self.params0):
                for (path, mine), (path0, given) in zip(self.scene_leaves(s), tree_items(p0)):
                    if path != path0 or mine.shape != given.shape:
                        raise RuntimeError(f"parameter {path} {tuple(mine.shape)} of the program "
                                           f"is not the benchmark's {path0} "
                                           f"{tuple(given.shape)}")
                    mine.copy_(given)
        for s, m in enumerate(self.models):
            m.gen.manual_seed(derived_seed(seed, 2, s))

    def start_at(self, step: int) -> None:
        """Put the schedule at `step`: the next step updates with lr(step)."""
        self.scheduler.last_epoch = step
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_schedule(step)

    def scene_leaves(self, s: int):
        """(path, leaf) of scene s: the program's leaves, or their scene-s
        slices in the multi-scene step."""
        if self.trainer is not None:
            return list(tree_items(self.params))
        return [(k, v[s]) for k, v in tree_items(self.params)]

    def leaf_state(self, s: int):
        """(path, leaf, the optimizer's state of it) of scene s."""
        out = []
        for (k, v), (_, full) in zip(self.scene_leaves(s), tree_items(self.params)):
            st = self.optimizer.state.get(full, {})
            if self.trainer is None:
                st = {n: t[s] for n, t in st.items() if torch.is_tensor(t) and t.dim() > 0}
            out.append((k, v, st))
        return out

    def generator_states(self) -> list:
        return [m.gen.get_state() for m in self.models]

    def scene_data(self, s: int) -> dict:
        """Scene s's training photos and cameras (numpy), read from the files
        by the benchmark, not from the program."""
        return photos.load(self.scenes[s], data_root())

    def step(self, step: int):
        """One optimizer step of every scene (the timed call)."""
        if self.trainer is not None:
            return self.trainer.train_step(step)
        with self.precision():
            log = self.ms.train_step(self.optimizer, step)
        self.scheduler.step()
        return log

    def scene_logs(self, log) -> list:
        """Each scene's log, from what `step` returned."""
        return [log] if self.trainer is not None else [log[s] for s in self.ms.scenes]

    def close(self) -> None:
        """Drop every reference to the program's state."""
        for name in ("trainer", "ms", "models", "params", "optimizer", "scheduler", "precision"):
            self.__dict__.pop(name, None)
