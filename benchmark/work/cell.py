"""A cell's work counts, which its workload file freezes under `work`.

    python3 -m benchmark.work.cell <cell> [<cell> ...]

prints, for each cell, the counts as the file should hold them: B1's and
B2's from the closed forms at the cell's rows, and the step's FLOPs from
FlopCounterMode over one step of the plain reference at the cell's shapes
(on the card; every scene of a step has the same shapes).
"""
from __future__ import annotations

import json
import sys

from benchmark.work import sdf_grad, shader


def rows(config: dict, workload: dict) -> int:
    """SDF points (= shader rows) of one step over the cell's scenes."""
    n_inner = config.get("n_samples", 64) + config.get("n_importance", 64)
    return len(workload["scenes"]) * config.get("train_ray_num", 512) * n_inner


def kernel_work(config: dict, workload: dict) -> dict:
    n = rows(config, workload)
    sc = dict(config.get("shader_config") or {})
    m = config.get("sdf_freq", 6)
    return {"sdf_grad": {"flops": sdf_grad.flops(n, m), "bytes": sdf_grad.min_bytes(n, m)},
            "shader": {"flops": shader.flops(n, sc), "bytes": shader.min_bytes(n, sc)}}


def step_flops(config: dict, workload: dict, device="cuda") -> float:
    """FLOPs of one training step of the plain reference: forward, loss and
    backward, as FlopCounterMode counts them, times the cell's scenes."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.harness.weights import make_params
    from benchmark.reference import fields
    from benchmark.reference.stage1 import losses, ray_batch, scene_tensors, settings

    s = settings(config)
    res = 8
    scene = {"imgs": np.zeros((2, res, res, 3), np.uint8),
             "Ks": np.tile(np.array([[res, 0, res / 2], [0, res, res / 2], [0, 0, 1]],
                                    np.float32), (2, 1, 1)),
             "poses": np.tile(np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 3]], np.float32),
                              (2, 1, 1))}
    P = make_params(config, 0, device)
    lut = fields.fg_lut(device)
    gen = torch.Generator(device=device).manual_seed(0)
    batch = ray_batch(gen, scene_tensors(scene, device, False), s["train_ray_num"])
    with FlopCounterMode(display=False) as counter:
        total = sum(losses(P, s, lut, batch, workload["first_step"], gen, "f32").values())
        total.backward()
    return float(counter.get_total_flops()) * len(workload["scenes"])


def main(argv=None) -> None:
    from benchmark.harness import catalog

    for name in argv if argv is not None else sys.argv[1:]:
        w = catalog.workload(name)
        cfg = catalog.config(w["config"])
        print(json.dumps({"workload": name, "work": {"step_flops": step_flops(cfg, w),
                                                     **kernel_work(cfg, w)}}))


if __name__ == "__main__":
    main()
