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

The multi-scene layout (`save_stacked` / `load_stacked`) is nero_tpu's
checkpoint of a vmapped step (tools/train_multi_scene.py): the same keys,
every `P|` and `O|` leaf (and `R|gen`) with a leading scene axis, the counts
of shape [S].
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


def _tree_blob(params, optimizer, schedule_count: int) -> dict:
    """The `P|` and `O|` keys of one parameter tree."""
    blob = {"P" + _SEP + k: v.detach().cpu().numpy() for k, v in tree_items(params)}
    if optimizer is not None:
        if isinstance(optimizer, torch.optim.Adam):
            blob.update(_adam_blob(params, optimizer))
        elif not isinstance(optimizer, torch.optim.SGD) or any(optimizer.state.values()):
            raise NotImplementedError(f"checkpointing {type(optimizer).__name__}: nero_tpu's "
                                      "format holds optax.adam or momentum-free optax.sgd")
        blob["O|1|count"] = np.asarray(schedule_count, np.int32)
    return blob


def _write(path: str, step: int, best_para: float, blob: dict):
    """`blob` and the header into `path`, atomically."""
    blob = {"__step__": np.asarray(step, np.int64),
            "__best_para__": np.asarray(best_para, np.float64), **blob}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **blob)
    os.replace(tmp, path)


def save_checkpoint(path: str, step: int, best_para: float, params,
                    optimizer: torch.optim.Optimizer | None = None,
                    schedule_count: int | None = None,
                    generator: torch.Generator | None = None):
    """Write `path` atomically. `schedule_count` is the schedule's position
    (`step` when None); `generator` the model's batch generator."""
    blob = _tree_blob(params, optimizer, step if schedule_count is None else schedule_count)
    if generator is not None:
        blob["R|gen"] = generator.get_state().numpy()
    _write(path, step, best_para, blob)


def save_stacked(path: str, step: int, best_para: float, params,
                 optimizer: torch.optim.Optimizer | None = None,
                 schedule_count: int | None = None, generators: list | None = None):
    """The multi-scene checkpoint of parameters stacked on a leading scene
    axis (models/multi_scene.py): every leaf and its Adam moments as they
    are, the counts one per scene, and generator s's state at index s of
    `R|gen`."""
    blob = _tree_blob(params, optimizer, step if schedule_count is None else schedule_count)
    n = next(iter(blob.values())).shape[0]
    for k in ("O|0|count", "O|1|count"):
        if k in blob:
            blob[k] = np.full(n, blob[k], np.int32)
    if generators is not None:
        blob["R|gen"] = np.stack([g.get_state().numpy() for g in generators])
    _write(path, step, best_para, blob)


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
            "exp_avg": torch.from_numpy(np.asarray(data[f"O|0|mu|{k}"])).to(leaf.device)
                            .reshape(leaf.shape),
            "exp_avg_sq": torch.from_numpy(np.asarray(data[f"O|0|nu|{k}"])).to(leaf.device)
                               .reshape(leaf.shape),
        }


class _SceneCounts:
    """A stacked checkpoint read as one tree's: the leaves and moments whole,
    the counts (one per scene, equal) as one."""

    def __init__(self, data):
        self.data = data

    def __getitem__(self, key):
        v = self.data[key]
        return v[0] if key in ("O|0|count", "O|1|count") else v


def _load_tree(data, files: set, step: int, params, optimizer, scheduler, generator) -> bool:
    """Load one tree's keys (`data[key]`); returns whether optimizer state
    was stored."""
    with torch.no_grad():
        for k, leaf in tree_items(params):
            key = "P" + _SEP + k
            if key not in files:
                raise KeyError(f"checkpoint missing leaf {k}")
            leaf.copy_(torch.from_numpy(np.asarray(data[key])))
    has_opt = "O|1|count" in files
    if optimizer is not None and has_opt and isinstance(optimizer, torch.optim.Adam):
        if "O|0|count" not in files:
            raise KeyError("checkpoint holds no Adam state (O|0|count)")
        _load_adam(data, params, optimizer)
    if scheduler is not None:
        scheduler.last_epoch = int(data["O|1|count"]) if has_opt else step
    if generator is not None and "R|gen" in files:
        generator.set_state(torch.from_numpy(np.asarray(data["R|gen"])))
    return has_opt


def load_checkpoint(path: str, params, optimizer: torch.optim.Optimizer | None = None,
                    scheduler=None, generator: torch.Generator | None = None):
    """Copy the stored leaves into `params` in place and, where given and
    stored, the optimizer state, the scheduler's position (`last_epoch`)
    and the generator's state. Returns (step, best_para)."""
    with np.load(path, allow_pickle=False) as data:
        step, best_para = int(data["__step__"]), float(data["__best_para__"])
        has_opt = _load_tree(data, set(data.files), step, params, optimizer, scheduler,
                             generator)
    if optimizer is not None and not has_opt and os.path.exists(path + ".opt"):
        optimizer.load_state_dict(torch.load(path + ".opt"))
    return step, best_para


def load_stacked(path: str, params, optimizer: torch.optim.Optimizer | None = None,
                 scheduler=None, generators: list | None = None):
    """Load a multi-scene checkpoint (the port's or nero_tpu's) into the
    stacked parameters, the optimizer, the scheduler and each scene's
    generator. Returns (step, best_para)."""
    with np.load(path, allow_pickle=False) as data:
        step, best_para = int(data["__step__"]), float(data["__best_para__"])
        files = set(data.files)
        _load_tree(_SceneCounts(data), files - {"R|gen"}, step, params, optimizer, scheduler,
                   None)
        if generators is not None and "R|gen" in files:
            for g, state in zip(generators, data["R|gen"]):
                g.set_state(torch.from_numpy(np.asarray(state)))
    return step, best_para
