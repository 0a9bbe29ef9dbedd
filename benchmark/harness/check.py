"""What decides `correct`: the first steps of the timed object against the
plain reference, started from the same parameters, photos and generator
state.

The program's readings are taken in set-up, through the window's own call:
each of the first `STEPS` steps' loss terms, the first step's gradient as
the optimizer got it (Adam's first moment after one step over 1 - beta1),
and each leaf's change after the `STEPS` steps. The reference takes the
same steps once the window has closed. The numbers (each compared against
its limit in the workload's file, where the file gives one):

* `loss`: the largest relative gap of a scene's total loss over the steps;
* `loss_rgb`: the same of its colour term;
* `grad`: the gap of each layer's first-step gradient norm (its leaves
  pooled: `v`, `g` and `b` of a weight-normed layer), against the
  reference's norm of that layer or of the median layer, whichever is
  larger; the worst layer. Not the worst leaf: a weight-norm gain's
  gradient is its layer's weight gradient projected on the layer's
  direction, which on some seeds cancels to a hundredth of its usual norm
  while its rounding does not (PERF.md has the readings); the layer's
  gradient holds steady, and a layer lost or halved reads 1 or 0.5 all
  the same;
* `change`: the gap of each leaf's change over the steps, against the
  reference's change of that leaf or of the median leaf, whichever is
  larger; the worst leaf, leaving out the leaves whose reference gradient
  is under a thousandth of the median leaf's (they move under Adam by
  round-off alone);
* `occ_head`: in a step that runs the occlusion loss, the leaves of the
  head whose output (`occ_prob`) that loss supervises are held apart.
  There the head's gradient swings from seed to seed between the bfloat16
  program and the float32 reference as far as a float8 control moves it,
  chiefly in its weight-norm gains, worst in the last layer's one-number
  gain, a sum that nearly cancels; it swings as far with the program's
  candidates and traced truths handed to the reference (PERF.md has the
  readings). `grad` then covers every other layer. The inner light, whose
  colour the shader weights by `occ_prob`, changes as that head does, so
  `occ_head` is the worst change of the leaves of both, which still tells
  a head that moved from one that did not, and `change` covers the rest.
"""
from __future__ import annotations

import math
import statistics

import torch

from benchmark.reference.stage1 import run_steps, tree_items

STEPS = 3
BETA1 = 0.9
ROUND_OFF_LEAF = 1e-3
OCC_HEAD = "shader|inner_weight|"    # the head of occ_prob, the occlusion loss's output
OCC_WEIGHTED = "shader|inner_light|"  # the light that occ_prob weights


def program_readings(system, step0: int, steps: int = STEPS) -> dict:
    """Take `steps` steps of the system from `step0` and read them. Returns
    the inputs the reference needs too."""
    inputs = {"params0": system.params0, "gen_states": system.generator_states(),
              "step0": step0}
    start = [dict(tree_items(p)) for p in system.params0]
    losses, grads = [], None
    for i in range(steps):
        logs = system.scene_logs(system.step(step0 + i))
        losses.append([{k: float(v) for k, v in log.items()} for log in logs])
        if i == 0:
            grads = [{k: float(torch.linalg.norm(st["exp_avg"])) / (1 - BETA1) if "exp_avg" in st
                      else 0.0 for k, _, st in system.leaf_state(s)}
                     for s in range(len(system.scenes))]
    change = [{k: float(torch.linalg.norm(v.detach() - start[s][k].detach()))
               for k, v in system.scene_leaves(s)} for s in range(len(system.scenes))]
    return {"inputs": inputs, "losses": losses, "grad_norms": grads, "change_norms": change}


def _leaf_gaps(prog: dict, ref: dict, keys) -> list:
    """(gap, key) of each key of `keys` (leaves or layers), smallest first:
    |prog - ref| over the larger of the reference's norm and the median of
    `ref`'s; NaN reads inf."""
    floor = statistics.median(ref.values())
    gaps = []
    for k in keys:
        g = abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30)
        gaps.append((math.inf if math.isnan(g) else g, k))
    return sorted(gaps)


def by_layer(norms: dict) -> dict:
    """{layer: the norm of its leaves together}; a leaf's layer is its path
    without the last key (`sdf|8|g` -> `sdf|8`)."""
    sq = {}
    for k, v in norms.items():
        layer = k.rsplit("|", 1)[0]
        sq[layer] = sq.get(layer, 0.0) + v * v
    return {k: math.sqrt(v) for k, v in sq.items()}


def occ_phase(config: dict, step0: int) -> bool:
    """Whether the steps from `step0` run the occlusion loss."""
    return (config.get("apply_occ_loss", True) and "occ" in config.get("loss", ())
            and step0 >= config.get("occ_loss_step", 20000))


def compare(prog: dict, refs: list, occ: bool) -> dict:
    """The numbers of one run: {name: (value, where)}, each the worst over
    the scenes; `refs` each scene's `run_steps` result; `occ` whether the
    steps ran the occlusion loss (then `occ_head` is read apart)."""
    names = ("loss", "loss_rgb", "grad", "change") + (("occ_head",) if occ else ())
    worst = {k: (0.0, None) for k in names}

    def keep(name, g, where):
        g = math.inf if math.isnan(g) else g
        if g >= worst[name][0]:
            worst[name] = (g, where)

    for s, ref in enumerate(refs):
        for i, r in enumerate(ref["losses"]):
            for name, term in (("loss", "loss_total"), ("loss_rgb", "loss_rgb")):
                p = prog["losses"][i][s][term]
                keep(name, abs(p - r[term]) / max(abs(r[term]), 1e-30), f"scene {s} step {i}")
        rg = ref["grad_norms"]
        floor = statistics.median(rg.values())
        layers = sorted({k.rsplit("|", 1)[0] for k in rg
                         if not (occ and k.startswith(OCC_HEAD))})
        g, k = _leaf_gaps(by_layer(prog["grad_norms"][s]), by_layer(rg), layers)[-1]
        keep("grad", g, f"scene {s} {k}")
        moving = [k for k in rg if rg[k] >= ROUND_OFF_LEAF * floor]
        branch = [k for k in moving if occ and k.startswith((OCC_HEAD, OCC_WEIGHTED))]
        for name, keys in (("change", [k for k in moving if k not in branch]),
                           ("occ_head", branch)):
            if keys:
                g, k = _leaf_gaps(prog["change_norms"][s], ref["change_norms"], keys)[-1]
                keep(name, g, f"scene {s} {k}")
    return worst


def reference_readings(config: dict, inputs: dict, scenes: list, steps: int = STEPS,
                       mode: str = "f32", device="cuda") -> list:
    """Each scene's reference run (benchmark/reference/stage1.py), one after
    the other, freeing each before the next."""
    out = []
    for s, scene in enumerate(scenes):
        out.append(run_steps(config, inputs["params0"][s], scene, inputs["gen_states"][s],
                             inputs["step0"], steps, mode=mode, device=device))
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k][0] <= limits[k] for k in limits)
