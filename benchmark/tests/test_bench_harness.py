"""The harness on the CPU: its files load and find each other by name, a
new file adds a cell or a metric, the result line has the contract's keys,
a run without a card or without the program prints no result, and a run
with the timed path broken comes out not correct."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import catalog, check
from benchmark.harness.main import emit
from benchmark.tests.bench_common import copy_benchmark, run_tiny, tiny_cell

ROOT = os.path.dirname(catalog.HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_file_loads_and_names_are_valid():
    metrics = catalog.metrics()
    assert set(metrics) >= {"trainer.step_ms_p95", "step.host_ms", "step.mfu",
                            "render.library_ms", "sdf_grad_roofline", "shader_roofline",
                            "device.idle_share"}
    for name in catalog.workload_names():
        w = catalog.workload(name)
        cfg = catalog.config(w["config"])
        assert NAME.match(name) and NAME.match(w["config"])
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
        assert w["limits"] and set(w["limits"]) <= {"loss", "loss_rgb", "grad", "change",
                                                    "occ_head"}
        assert ("occ_head" in w["limits"]) == check.occ_phase(cfg, w["first_step"])
        assert all(os.path.exists(os.path.join(catalog.HERE, "scenes", f"{s}.json"))
                   for s in w["scenes"])
        assert all(NAME.match(k) for k in cfg["reduced"])
        assert cfg["source"].startswith("https://")
    for name, mod in metrics.items():
        assert NAME.match(name) and UNIT.match(mod.UNIT)
        assert mod.BETTER in ("lower", "higher") and mod.MOVES == "train_rays_per_s"


def test_manifest_matches_the_files():
    m = manifest()
    assert m["command"] == ["python3", "benchmark/run.py"] and m["paths"] == ["benchmark"]
    metrics = catalog.metrics()
    for c in m["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["reduced"] == catalog.config(c["name"])["reduced"]
    for w in m["workloads"]:
        f = catalog.workload(w["name"])
        assert (f["config"], f["why"], f["chips"]) == (w["config"], w["why"], w["chips"])
    for p in m["per_layer"]:
        mod = metrics[p["name"]]
        assert (p["unit"], p["better"], p["source"], p["layer"], p["moves"]) == (
            mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES)
    assert {e["name"] for e in m["end_to_end"]} == {"train_rays_per_s", "setup_s"}


def test_new_files_add_a_cell_and_a_metric(tmp_path):
    root = copy_benchmark(tmp_path)
    assert "tiny" not in catalog.workload_names(root)
    w = tiny_cell(root)
    assert "tiny" in catalog.workload_names(root)
    with open(os.path.join(root, "metrics", "window.steps.py"), "w") as f:
        f.write('LAYER = "trainer"\nUNIT = "steps"\nBETTER = "higher"\n'
                'SOURCE = "host_clock"\nMOVES = "train_rays_per_s"\n\n\n'
                'def read(record):\n    return float(record["window_steps"])\n')
    result, checks = run_tiny(root, w, trace=1)
    assert result["metrics"]["window.steps"] == {"value": float(result["attempted"]),
                                                 "unit": "steps"}
    assert "window.steps" not in catalog.metrics()


def test_result_line_has_the_contract_keys(tmp_path, capsys):
    root = copy_benchmark(tmp_path)
    result, checks = run_tiny(root, tiny_cell(root))
    emit(result, checks)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"train_rays_per_s", "setup_s"}
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert err.strip().splitlines()[-3:] == [
        f"check {k}: {c['value']!r} limit {c['limit']!r} ({c['where']})"
        for k, c in checks.items()]


def _run(cwd, *extra):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "shape_syn.occ",
                           "--seed", "4294967311", "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    p = _run(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_no_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    copy_benchmark(tmp_path)
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def _unchanged(system):
    system.optimizer.step = lambda *a, **k: None


def _half_batch(system):
    from benchmark.calibrate import half_batch

    cm = half_batch()
    cm.__enter__()
    system.undo = lambda: cm.__exit__(None, None, None)


def _layer_drop(system):
    from benchmark.calibrate import LAYER, grad_fault

    grad_fault(system, LAYER, 0.0)


def _head_drop(system):
    from benchmark.calibrate import fault_head, grad_fault

    grad_fault(system, fault_head(system), 0.0)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _layer_drop, _head_drop],
                         ids=["state_unchanged", "half_batch", "layer_drop", "head_drop"])
def test_a_broken_step_is_not_correct(tmp_path, fault):
    root = copy_benchmark(tmp_path)
    w = tiny_cell(root, limits=catalog.workload("shape_syn.occ")["limits"])
    holder = {}

    def plant(system):
        fault(system)
        holder["system"] = system

    try:
        result, checks = run_tiny(root, w, fault=plant)
    finally:
        undo = getattr(holder.get("system"), "undo", None)
        if undo:
            undo()
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in checks.values())


def test_the_program_reads_the_benchmarks_photos(tmp_path):
    from benchmark.harness import photos
    from benchmark.harness.program import System, data_root

    root = copy_benchmark(tmp_path)
    w = tiny_cell(root, scenes=("capture",))
    photos.ensure(w["scenes"][0], data_root(), "cpu", root)
    system = System(catalog.config(w["config"], root), w, 5, str(tmp_path), device="cpu")
    mine = system.scene_data(0)
    theirs = system.models[0].train_data
    assert mine["imgs"].shape == (3, 24, 32, 3) and mine["imgs"].std() > 10
    assert (theirs["imgs_u8"].numpy() == mine["imgs"]).all()
    assert (theirs["poses"].numpy() == mine["poses"]).all()
    centre = -mine["poses"][:, :, :3].transpose(0, 2, 1) @ mine["poses"][:, :, 3:]
    ahead = mine["poses"][:, 2, :3]
    assert ((ahead[:, None] @ -centre)[..., 0, 0] > 0.99 * (centre[:, :, 0] ** 2).sum(-1)
            ** 0.5).all()
