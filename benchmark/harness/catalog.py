"""Finds the benchmark's pieces by name: a cell is
`workloads/<name>.json`, its configuration `configs/<config>.json`, a
per-layer metric `metrics/<name>.py` (a module with LAYER, UNIT, BETTER,
SOURCE, MOVES and `read(record) -> float | None`). Adding a file adds the
piece; nothing else is edited."""
from __future__ import annotations

import glob
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_KEYS = ("LAYER", "UNIT", "BETTER", "SOURCE", "MOVES")


def workload(name: str, root: str = HERE) -> dict:
    path = os.path.join(root, "workloads", f"{name}.json")
    if not os.path.exists(path):
        raise SystemExit(f"no cell {name!r}: {path} does not exist")
    with open(path) as f:
        w = json.load(f)
    w["name"] = name
    return w


def config(name: str, root: str = HERE) -> dict:
    with open(os.path.join(root, "configs", f"{name}.json")) as f:
        return json.load(f)


def workload_names(root: str = HERE) -> list:
    return sorted(os.path.basename(p)[:-5] for p in glob.glob(os.path.join(root, "workloads",
                                                                           "*.json")))


def metrics(root: str = HERE) -> dict:
    """{metric name: its module}, one per file of `metrics/`."""
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "metrics", "*.py"))):
        name = os.path.basename(path)[:-3]
        if name.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"),
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        missing = [k for k in METRIC_KEYS if not hasattr(mod, k)] + (
            [] if callable(getattr(mod, "read", None)) else ["read"])
        if missing:
            raise SystemExit(f"metric {name}: {path} lacks {missing}")
        out[name] = mod
    return out
