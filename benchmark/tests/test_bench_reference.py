"""The plain reference against the port's step on the CPU, at a tiny size
(full widths, 8 rays a step): the harness's own comparison, through the
port's plain paths in float32, reads no more than float32 round-off; the
control (the reference on float8 products) reads far more. The colour term
stands for the loss here: the total holds the occlusion and eikonal terms,
in which Adam carries the round-off of near-zero gradients into the later
steps at about 1e-4."""
from __future__ import annotations

import pytest
import torch

from benchmark.calibrate import as_program
from benchmark.harness import check
from benchmark.harness.program import System
from benchmark.tests.bench_common import copy_benchmark, run_tiny, tiny_cell

CPU_ROUND_OFF = {"loss_rgb": 1e-4, "grad": 1e-4, "change": 1e-2}


@pytest.mark.parametrize("config,scenes,first_step", [
    ("nero_shape_syn", ("sphere",), 25000),
    ("nero_shape_real", ("capture",), 25000),
    ("nero_shape_syn", ("sphere",), 6000),
    ("nero_shape_syn", ("sphere", "pair"), 25000),
], ids=["syn_occ", "real_occ", "syn_early", "syn_two_scenes"])
def test_reference_follows_the_port(tmp_path, config, scenes, first_step):
    root = copy_benchmark(tmp_path)
    w = tiny_cell(root, config=config, scenes=scenes, first_step=first_step,
                  limits=CPU_ROUND_OFF)
    result, checks = run_tiny(root, w)
    assert result["correct"], checks


def test_control_reads_far_more_than_the_program(tmp_path):
    root = copy_benchmark(tmp_path)
    w = tiny_cell(root)
    from benchmark.harness import catalog

    cfg = catalog.config(w["config"], root)
    system = System(cfg, w, 12345, str(tmp_path), device="cpu")
    system.start_at(w["first_step"])
    scenes = [system.scene_data(0)]
    inputs = {"params0": system.params0, "gen_states": system.generator_states(),
              "step0": w["first_step"]}
    prog = check.program_readings(system, w["first_step"])
    ref = check.reference_readings(cfg, inputs, scenes, device="cpu")
    control = as_program(check.reference_readings(cfg, inputs, scenes, mode="fp8",
                                                  device="cpu"))
    sound, low = check.compare(prog, ref, True), check.compare(control, ref, True)
    assert low["grad"][0] > 10 * sound["grad"][0] and low["loss"][0] > 10 * sound["loss"][0]


def test_the_programs_candidates_reach_the_reference(tmp_path):
    """The looks at the occlusion head's gap (`calibrate.py --mode
    program_mask|program_truth`): the program's candidate masks and traced
    truths are recorded step by step and handed to the reference, which
    counts where they differ from its own. In float32 on both sides they
    are the same, and so is the occlusion term."""
    from benchmark.calibrate import given_candidates, program_candidates
    from benchmark.harness import catalog, photos
    from benchmark.harness.program import data_root

    root = copy_benchmark(tmp_path)
    w = tiny_cell(root)
    cfg = catalog.config(w["config"], root)
    photos.ensure(w["scenes"][0], data_root(), "cpu", root)
    system = System(cfg, w, 2 ** 31 + 7, str(tmp_path), device="cpu")
    system.start_at(w["first_step"])
    scenes = [system.scene_data(0)]
    masks, counts, truths, gaps = [], [], [], []
    with program_candidates(masks, truths):
        prog = check.program_readings(system, w["first_step"])
    with given_candidates(masks, counts, truths, gaps):
        given = check.reference_readings(cfg, prog["inputs"], scenes, device="cpu")
    own = check.reference_readings(cfg, prog["inputs"], scenes, device="cpu")
    assert len(counts) == len(gaps) == check.STEPS and sum(c[0] for c in counts) > 0
    assert all(c[0] == c[1] and c[2] == 0 for c in counts), counts
    assert all(g[0] < 1e-5 and g[1] == 0 for g in gaps), gaps
    for a, b in zip(given[0]["losses"], own[0]["losses"]):
        assert a["loss_occ"] == pytest.approx(b["loss_occ"], rel=1e-5)


def test_fp8_product_differentiates_twice():
    from benchmark.reference.fields import matmul

    x = torch.randn(5, 4, dtype=torch.float64, requires_grad=True)
    w = torch.randn(4, 3, dtype=torch.float64, requires_grad=True)
    y = matmul(x, w, "fp8")
    (gx,) = torch.autograd.grad(y.sum(), x, create_graph=True)
    gx.pow(2).sum().backward()
    assert w.grad is not None and torch.all(torch.isfinite(w.grad))
    assert not torch.allclose(y, x @ w)
