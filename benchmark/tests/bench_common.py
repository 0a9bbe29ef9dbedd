"""Helpers of the benchmark's CPU tests: a copy of the benchmark folder with
a tiny cell (full widths, 8 rays a step, 4 views of 32 pixels of the
benchmark's scenes) that the harness runs on the CPU through the port's
plain paths."""
from __future__ import annotations

import json
import os
import shutil
import time
import types

from benchmark.harness import catalog

# the program's data root, as benchmark/run.py sets it, before the program loads
os.environ.setdefault("NERO_TPU_DATA_ROOT", os.path.join(os.path.dirname(catalog.HERE),
                                                         "build", "benchmark_data"))
TINY = 32


def tiny_scene(root: str, scene: str) -> str:
    """Write scenes/tiny_<scene>.json: the scene at 4 views of 32 pixels."""
    from benchmark.harness import photos

    s = photos.spec(scene, root)
    k = TINY / s["width"]
    s.update(views=4, width=TINY, height=round(s["height"] * k), focal=s["focal"] * k)
    name = f"tiny_{scene}"
    with open(os.path.join(root, "scenes", f"{name}.json"), "w") as f:
        json.dump(s, f)
    return name


def copy_benchmark(tmp_path) -> str:
    root = os.path.join(str(tmp_path), "benchmark")
    shutil.copytree(catalog.HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    return root


def tiny_cell(root: str, name: str = "tiny", config: str = "nero_shape_syn", rays: int = 8,
              scenes=("sphere",), first_step: int = 25000, limits=None) -> dict:
    """Write configs/<name>.json (the config at `rays` rays, f32 storage as
    on the CPU) and workloads/<name>.json; returns the workload."""
    cfg = catalog.config(config, root)
    cfg.update(train_ray_num=rays, bf16_hidden=False)
    with open(os.path.join(root, "configs", f"{name}.json"), "w") as f:
        json.dump(cfg, f)
    w = {"config": name, "scenes": [tiny_scene(root, s) for s in scenes],
         "first_step": first_step,
         "warmup_steps": 1, "chips": 1, "why": "a tiny cell of the harness's CPU tests",
         "work": {"step_flops": 1e9},
         "limits": limits or {"loss_rgb": 1e-4, "grad": 1e-3, "change": 1e-2}}
    with open(os.path.join(root, "workloads", f"{name}.json"), "w") as f:
        json.dump(w, f)
    return catalog.workload(name, root)


def run_tiny(root: str, w: dict, trace: int = 0, seed: int = 2 ** 31 + 7, fault=None,
             seconds: float = 0.2):
    """(result, checks) of the harness's run of a tiny cell on the CPU."""
    from benchmark.harness.main import run_cell

    args = types.SimpleNamespace(workload=w["name"], seed=seed, seconds=seconds, trace=trace)
    return run_cell(args, w, time.perf_counter(), device="cpu", root=root, fault=fault)
