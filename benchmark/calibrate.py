"""Readings that set a cell's limits: the numbers `correct` compares, for
the program on many seeds (the lower readings), for the control (the
reference in the program's place, its products on float8 e4m3 operands,
the precision below the configuration's bfloat16) and for planted faults:

* `half_batch`: half of each step's rays left out, the mean taken over the rest;
* `layer_drop`: one SDF layer's gradient lost before the optimizer (B1's
  backward missing one layer's dW);
* `head_drop`: one of B2's heads' gradient lost (the photographer's light
  where the configuration has it, else the outer light);
* `layer_half`: that SDF layer's gradient halved (a factor of two lost).

`program_mask`, `program_truth` and `no_occ` are no faults but looks: the
reference takes the occlusion loss's candidates from the program's own SDF
instead of its own (and with `program_truth` also the program's traced
truth of each candidate), and each line counts where the two sides differ;
`no_occ` runs both sides with the occlusion loss switched off
(`apply_occ_loss` false), the rest of the cell as it is.

    python3 benchmark/calibrate.py --workload <cell> --mode <mode> \\
        --seeds 11 12 13 [--dump build/readings.jsonl]

One process builds each seed's system in turn, at the cell's own size, on
the card. Each line of output is one seed's numbers.
"""
import argparse
import contextlib
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("NERO_TPU_DATA_ROOT", os.path.join(ROOT, "build", "benchmark_data"))

import torch  # noqa: E402

from benchmark.harness import catalog, check, photos  # noqa: E402
from benchmark.harness.program import System, data_root  # noqa: E402
from benchmark.reference import stage1  # noqa: E402

LAYER = "sdf|4|"
MODES = ("program", "control", "half_batch", "layer_drop", "head_drop", "layer_half",
         "program_mask", "program_truth", "no_occ")


@contextlib.contextmanager
def half_batch():
    """The timed path broken: each scene's ray batch keeps its first half."""
    from nero_tpu_torch.models import multi_scene, shape

    real = shape.sample_ray_batch

    def halved(*a, **k):
        batch = real(*a, **k)
        return {key: v[:v.shape[0] // 2] for key, v in batch.items()}

    shape.sample_ray_batch = multi_scene.sample_ray_batch = halved
    try:
        yield
    finally:
        shape.sample_ray_batch = multi_scene.sample_ray_batch = real


def fault_head(system) -> str:
    names = [k for k, _ in stage1.tree_items(system.params)]
    return next((p for p in ("shader|human_light|", "shader|outer_light|")
                 if any(k.startswith(p) for k in names)))


def grad_fault(system, prefix: str, factor: float) -> None:
    """The timed path broken: the gradient of the leaves under `prefix` is
    multiplied by `factor` before each optimizer step."""
    leaves = [v for k, v in stage1.tree_items(system.params) if k.startswith(prefix)]
    real = system.optimizer.step

    def step(*a, **k):
        with torch.no_grad():
            for p in leaves:
                if p.grad is not None:
                    p.grad.mul_(factor)
        return real(*a, **k)

    system.optimizer.step = step


@contextlib.contextmanager
def program_candidates(record: list, truths: list | None = None):
    """Record the occlusion loss's candidate mask of each program step and,
    with `truths`, the traced truth of its candidates."""
    from nero_tpu_torch.render import shape

    real, real_trace = shape.compute_occ_loss, shape.get_intersection

    def recording(params, scfg, gen, points, reflective, occ_prob, sdf, grads, dirs, *a, **k):
        record.append(stage1.occ_candidates(points, sdf, grads, dirs, scfg.occ_sdf_thresh)
                      .detach().clone())
        return real(params, scfg, gen, points, reflective, occ_prob, sdf, grads, dirs, *a, **k)

    def tracing(*a, **k):
        out = real_trace(*a, **k)
        truths.append(torch.sum(out[1], dim=-1).detach().float().clone())
        return out

    shape.compute_occ_loss = recording
    if truths is not None:
        shape.get_intersection = tracing
    try:
        yield
    finally:
        shape.compute_occ_loss, shape.get_intersection = real, real_trace


@contextlib.contextmanager
def given_candidates(masks: list, counts: list, truths: list | None = None,
                     gaps: list | None = None):
    """The reference's occlusion loss takes these masks, one a step, and
    counts (program's, reference's own, differing) candidates; with
    `truths`, also the program's truths, and `gaps` gets (mean |gap|,
    candidates whose truths differ by more than 0.5, candidates)."""
    real, real_truth = stage1.occ_candidates, stage1.occlusion_truth
    it, it_truth = iter(masks), iter(truths or ())

    def given(*a):
        own, theirs = real(*a), next(it)
        counts.append([int(theirs.sum()), int(own.sum()), int((own != theirs).sum())])
        return theirs

    def given_truth(*a, **k):
        own, theirs = real_truth(*a, **k), next(it_truth)
        d = (own - theirs).abs()
        gaps.append([float(d.mean()), int((d > 0.5).sum()), int(d.numel())])
        return theirs.to(own.dtype)

    stage1.occ_candidates = given
    if truths is not None:
        stage1.occlusion_truth = given_truth
    try:
        yield
    finally:
        stage1.occ_candidates, stage1.occlusion_truth = real, real_truth


def as_program(refs: list) -> dict:
    """Reference runs laid out as `check.program_readings` lays out the program's."""
    return {"losses": [[r["losses"][i] for r in refs] for i in range(len(refs[0]["losses"]))],
            "grad_norms": [r["grad_norms"] for r in refs],
            "change_norms": [r["change_norms"] for r in refs]}


def reading(w: dict, cfg: dict, seed: int, mode: str, device="cuda") -> tuple:
    extra = {}
    with tempfile.TemporaryDirectory() as tmp:
        for scene in w["scenes"]:
            photos.ensure(scene, data_root(), device)
        system = System(cfg, w, seed, tmp, device=device)
        system.start_at(w["first_step"])
        scenes = [system.scene_data(s) for s in range(len(system.scenes))]
        masks, counts, truths, gaps = [], [], [], []
        looks = mode in ("program_mask", "program_truth")
        with_truth = truths if mode == "program_truth" else None
        if mode == "control":
            inputs = {"params0": system.params0, "gen_states": system.generator_states(),
                      "step0": w["first_step"]}
            prog = as_program(check.reference_readings(cfg, inputs, scenes, mode="fp8",
                                                       device=device))
        else:
            if mode in ("layer_drop", "layer_half"):
                grad_fault(system, LAYER, 0.0 if mode == "layer_drop" else 0.5)
            elif mode == "head_drop":
                extra["head"] = fault_head(system)
                grad_fault(system, extra["head"], 0.0)
            ctx = (half_batch() if mode == "half_batch"
                   else program_candidates(masks, with_truth) if looks
                   else contextlib.nullcontext())
            with ctx:
                prog = check.program_readings(system, w["first_step"])
            inputs = prog["inputs"]
        system.close()
        with (given_candidates(masks, counts, with_truth, gaps) if looks
              else contextlib.nullcontext()):
            refs = check.reference_readings(cfg, inputs, scenes, device=device)
        if counts:
            extra["candidates_program_reference_differing"] = counts
        if gaps:
            extra["truth_mean_gap_over_half_of"] = gaps
    detail = {"program": {k: prog[k] for k in ("losses", "grad_norms", "change_norms")},
              "reference": refs}
    numbers = check.compare(prog, refs, check.occ_phase(cfg, w["first_step"]))
    return numbers, detail, extra


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=MODES, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dump", default=None, help="also write every leaf's readings here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("calibration reads the card: no CUDA device")
    w = catalog.workload(args.workload)
    cfg = catalog.config(w["config"])
    if args.mode == "no_occ":
        cfg = {**cfg, "apply_occ_loss": False}
    for seed in args.seeds:
        nums, detail, extra = reading(w, cfg, seed, args.mode)
        if args.dump:
            with open(args.dump, "a") as f:
                f.write(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                                    **detail}) + "\n")
        line = json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                           **{k: {"value": v, "where": where} for k, (v, where) in nums.items()},
                           **extra})
        print(line, flush=True)


if __name__ == "__main__":
    main()
