"""On the card, at a cell's own size: the control (the reference in the
program's place, its products on float8 e4m3 operands) and the planted
faults (half of the batch left out; one SDF layer's gradient lost; one of
the shader's heads' gradient lost) each come out not correct against the
cell's limits, on three seeds. Run with `python3 -m pytest benchmark/tests/test_bench_control.py -m gpu`."""
from __future__ import annotations

import pytest

from benchmark.harness import catalog, check


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read at the cell's own size")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["control", "half_batch", "layer_drop", "head_drop"])
@pytest.mark.parametrize("cell", ["shape_syn.occ", "shape_real.occ", "shape_syn.scenes4"])
def test_control_and_fault_fail(card, cell, mode):
    from benchmark.calibrate import reading

    if cell not in catalog.workload_names():
        pytest.skip(f"{cell} is not a cell of this benchmark")
    w = catalog.workload(cell)
    cfg = catalog.config(w["config"])
    for seed in (101, 202, 303):
        numbers, _, _ = reading(w, cfg, seed, mode)
        assert not check.verdict(numbers, w["limits"]), (seed, numbers)
