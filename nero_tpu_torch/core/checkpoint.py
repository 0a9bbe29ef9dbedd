"""Single-file checkpoints for the port: {step, best_para, params, optimizer}.

Parameters are stored as a flat `.npz` keyed by '|'-joined tree paths (the
same key scheme nero_tpu uses), the optimizer state with `torch.save` beside
it. Reading nero_tpu's own npz checkpoints is a later slice.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from nero_tpu_torch.core.convert import tree_items


def save_checkpoint(path: str, step: int, best_para: float, params,
                    optimizer: torch.optim.Optimizer | None = None):
    blob = {"__step__": np.asarray(step, np.int64),
            "__best_para__": np.asarray(best_para, np.float64)}
    for k, v in tree_items(params):
        blob["P|" + k] = v.detach().cpu().numpy()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **blob)
    os.replace(tmp, path)
    if optimizer is not None:
        torch.save(optimizer.state_dict(), path + ".opt")


def load_checkpoint(path: str, params, optimizer=None):
    """Copies the stored leaves into `params` in place; returns (step, best)."""
    with np.load(path, allow_pickle=False) as data:
        step = int(data["__step__"])
        best_para = float(data["__best_para__"])
        with torch.no_grad():
            for k, leaf in tree_items(params):
                key = "P|" + k
                if key not in data.files:
                    raise KeyError(f"checkpoint missing leaf {k}")
                leaf.copy_(torch.from_numpy(data[key]))
    if optimizer is not None and os.path.exists(path + ".opt"):
        optimizer.load_state_dict(torch.load(path + ".opt"))
    return step, best_para
