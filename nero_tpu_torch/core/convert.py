"""Weight bridge between nero_tpu parameter pytrees and the port's parameters.

Both packages hold parameters as nested dicts/lists whose leaves are arrays.
The port keeps the JAX layout exactly: a dense layer is `{v [in,out],
g [1,out], b [out]}` (nero_tpu/ops/mlp.py:99-110), so the trainable leaves
are the same weight-norm parameterisation and a test compares like with like.
The bridge takes the JAX tree as numpy arrays (the caller converts with
`np.asarray`), so this module needs nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def tree_map(fn, tree):
    """Apply `fn` to every leaf of a nested dict/list/tuple tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """Leaves in deterministic order (dict keys sorted, like jax.tree_util)."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def tree_items(tree, prefix: str = ""):
    """(path, leaf) pairs; paths join keys/indices with '|'."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}{k}|")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}{i}|")
    else:
        yield prefix[:-1], tree


def from_numpy_tree(tree, device="cpu", requires_grad: bool = True):
    """nero_tpu pytree (numpy leaves) -> port parameters (float32 tensors)."""
    def leaf(a):
        t = torch.from_numpy(np.array(a, np.float32)).to(device)
        return t.requires_grad_(requires_grad)
    return tree_map(leaf, tree)


def to_numpy_tree(tree):
    """Port parameters -> nested dicts/lists of numpy float32 arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
