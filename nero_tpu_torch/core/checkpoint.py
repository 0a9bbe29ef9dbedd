"""Single-file checkpoints in nero_tpu's format (nero_tpu/core/checkpoint.py).

One `.npz`, written and read by both packages:

* `__step__`, `__best_para__`;
* `P|<path>`: each parameter, keyed by its '|'-joined tree path;
* `O|<path>`: the optimizer state as nero_tpu's `_flatten` lays out the
  state of `optax.adam(schedule)`: `O|0|count` (the Adam count, int32),
  `O|0|mu|<path>` and `O|0|nu|<path>` (the first and second moments),
  `O|1|count` (the schedule's count); of `optax.sgd(schedule)`, `O|1|count`
  alone. They map to `torch.optim.Adam`'s per-parameter `step`, `exp_avg`
  and `exp_avg_sq` and to the position of the trainer's LambdaLR;
* `R|gen`: the state of the model's `torch.Generator`, so that a resumed
  run draws the batches of the unbroken one (nero_tpu derives its keys from
  the step and reads no `R|` key).

A port checkpoint written before the `O|` keys, whose optimizer state is a
`torch.save` file `<path>.opt` beside it, still loads.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from nero_tpu_torch.core.convert import tree_items

_SEP = "|"


def _adam_blob(params, optimizer: torch.optim.Adam) -> dict:
    blob, count = {}, 0
    for k, leaf in tree_items(params):
        st = optimizer.state.get(leaf, {})
        if "step" in st:
            count = max(count, int(st["step"]))
        for name, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            v = st.get(key)
            blob[f"O|0|{name}|{k}"] = (np.zeros(tuple(leaf.shape), np.float32) if v is None
                                       else v.detach().float().cpu().numpy())
    blob["O|0|count"] = np.asarray(count, np.int32)
    return blob


def save_checkpoint(path: str, step: int, best_para: float, params,
                    optimizer: torch.optim.Optimizer | None = None,
                    schedule_count: int | None = None,
                    generator: torch.Generator | None = None):
    """Write `path` atomically. `schedule_count` is the schedule's position
    (`step` when None); `generator` the model's batch generator."""
    blob = {"__step__": np.asarray(step, np.int64),
            "__best_para__": np.asarray(best_para, np.float64)}
    for k, v in tree_items(params):
        blob["P" + _SEP + k] = v.detach().cpu().numpy()
    if optimizer is not None:
        if isinstance(optimizer, torch.optim.Adam):
            blob.update(_adam_blob(params, optimizer))
        elif not isinstance(optimizer, torch.optim.SGD) or any(optimizer.state.values()):
            raise NotImplementedError(f"checkpointing {type(optimizer).__name__}: nero_tpu's "
                                      "format holds optax.adam or momentum-free optax.sgd")
        blob["O|1|count"] = np.asarray(step if schedule_count is None else schedule_count,
                                       np.int32)
    if generator is not None:
        blob["R|gen"] = generator.get_state().numpy()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **blob)
    os.replace(tmp, path)


def _load_adam(data, params, optimizer: torch.optim.Adam):
    count = float(data["O|0|count"])
    fused = {id(p): g["fused"] or g["capturable"]
             for g in optimizer.param_groups for p in g["params"]}
    for k, leaf in tree_items(params):
        on_device = fused[id(leaf)]
        optimizer.state[leaf] = {
            # where torch.optim.Adam keeps its step (on the parameter's
            # device when fused or capturable, else on the host)
            "step": torch.tensor(count, dtype=torch.float32,
                                 device=leaf.device if on_device else "cpu"),
            "exp_avg": torch.from_numpy(data[f"O|0|mu|{k}"]).to(leaf.device).reshape(leaf.shape),
            "exp_avg_sq": torch.from_numpy(data[f"O|0|nu|{k}"]).to(leaf.device)
                               .reshape(leaf.shape),
        }


def load_checkpoint(path: str, params, optimizer: torch.optim.Optimizer | None = None,
                    scheduler=None, generator: torch.Generator | None = None):
    """Copy the stored leaves into `params` in place and, where given and
    stored, the optimizer state, the scheduler's position (`last_epoch`)
    and the generator's state. Returns (step, best_para)."""
    with np.load(path, allow_pickle=False) as data:
        files = set(data.files)
        step = int(data["__step__"])
        best_para = float(data["__best_para__"])
        with torch.no_grad():
            for k, leaf in tree_items(params):
                key = "P" + _SEP + k
                if key not in files:
                    raise KeyError(f"checkpoint missing leaf {k}")
                leaf.copy_(torch.from_numpy(data[key]))
        has_opt = "O|1|count" in files
        if optimizer is not None and has_opt and isinstance(optimizer, torch.optim.Adam):
            if "O|0|count" not in files:
                raise KeyError("checkpoint holds no Adam state (O|0|count)")
            _load_adam(data, params, optimizer)
        if scheduler is not None:
            scheduler.last_epoch = int(data["O|1|count"]) if has_opt else step
        if generator is not None and "R|gen" in files:
            generator.set_state(torch.from_numpy(data["R|gen"]))
    if optimizer is not None and not has_opt and os.path.exists(path + ".opt"):
        optimizer.load_state_dict(torch.load(path + ".opt"))
    return step, best_para
