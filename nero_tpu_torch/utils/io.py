"""Small host IO helpers: pickle, h5, yaml config, directories. The port's
own copy of nero_tpu/utils/io.py. `h5py` is imported inside the h5
functions: nothing on the training path calls them."""
from __future__ import annotations

import os
import pickle

import numpy as np


def read_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pickle(obj, path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_cfg(path: str) -> dict:
    from nero_tpu_torch.core.config import load_cfg as _load
    return _load(path)


def save_h5(data: dict, path: str):
    import h5py
    with h5py.File(path, "w") as f:
        for k, v in data.items():
            f.create_dataset(k, data=np.asarray(v))


def read_h5(path: str) -> dict:
    import h5py
    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k]) for k in f.keys()}


def make_dir(path: str):
    os.makedirs(path, exist_ok=True)
