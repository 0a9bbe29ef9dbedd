"""The scene axis of the multi-scene step (models/multi_scene.py).

nero_tpu stacks every parameter leaf of S scenes on a leading axis and
`jax.vmap`s one scene's step over it. Here the parameters are stacked the
same way (leaf [S, ...]) and the rows of all scenes form one batch,
scene-major: scene s's rows are the s-th of S equal parts along the leading
axis. Per-row operations take that batch as they take one scene's. What
applies a scene's parameters or reduces over a scene's rows goes through
this module, and where a library call could sum in another order at another
size it runs scene by scene on the shapes of one scene, so that each scene's
numbers are those of the scene stepped alone, to the bit:

* `n_scenes(params)`: S of a stacked shape-model tree, None of one scene's;
* `stack_trees(trees)`: S scenes' trees as one of stacked leaves;
* `scene_slice(tree, s)`: scene s's leaves (views);
* `scene_map(fn, S, params, *rows)`: fn on each scene's parameters and rows,
  the results concatenated along the rows;
* `scene_sum(x, S)`: each scene's sum, [S] (x.sum() without scenes);
* `per_row(v, x)`: a per-scene value [S] broadcast to x's shape, whose
  gradient sums each scene's block as one scene's broadcast of a scalar does;
* `row_values(v, x)`: the same without a gradient, one value a row;
* `scene_rand(gen, device, dtype)`: draws from one generator, or from each
  scene's of a list.
"""
from __future__ import annotations

import torch


def n_scenes(params) -> int | None:
    """S of a Stage-I parameter tree stacked on a leading scene axis, read
    from its SDF's first layer (a weight [S, in, out], resolved or not);
    None of one scene's tree."""
    layer = params["sdf"][0]
    w = layer["w"] if "w" in layer else layer["v"]
    return w.shape[0] if w.dim() == 3 else None


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def stack_trees(trees: list):
    """S trees of the same structure -> one tree whose leaves are the S
    leaves stacked on a leading axis (new leaves, requiring grad), as
    `jnp.stack` stacks nero_tpu's."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_trees(list(t)) for t in zip(*trees))
    return torch.stack([t.detach() for t in trees]).requires_grad_(True)


def scene_slice(tree, s: int):
    """Scene s of a stacked tree: each leaf's view x[s]."""
    return _map_tree(lambda x: x[s], tree)


def scene_map(fn, S: int, params, *rows):
    """fn(scene s's parameters, scene s's part of each row tensor) for each
    scene, its output (a tensor or a tuple of them) concatenated along the
    leading axis. A row argument of None stays None."""
    parts = [None if r is None else r.chunk(S, 0) for r in rows]
    outs = [fn(scene_slice(params, s), *[None if p is None else p[s] for p in parts])
            for s in range(S)]
    if isinstance(outs[0], torch.Tensor):
        return torch.cat(outs, 0)
    return tuple(torch.cat(o, 0) for o in zip(*outs))


def scene_sum(x: torch.Tensor, S: int | None) -> torch.Tensor:
    """x.sum() without scenes; with S scenes each scene's block summed as one
    scene's tensor is (a contiguous block of the same shape), [S]."""
    if S is None:
        return x.sum()
    return torch.stack([c.sum() for c in x.chunk(S, 0)])


class _PerRow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, shape):
        S = v.shape[0]
        ctx.S = S
        rows = (S, shape[0] // S) + tuple(shape[1:])
        return v.reshape((S,) + (1,) * (len(rows) - 1)).expand(rows).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return scene_sum(g.contiguous(), ctx.S), None


def per_row(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """v as it multiplies x: a 0-d v (one scene) unchanged; a per-scene v
    [S] as a tensor of x's shape, each scene's block holding its value.
    Each use is a node of its own, whose gradient is each scene's block
    summed whole, as autograd sums the gradient of a scalar broadcast over
    one scene's tensor."""
    if v.dim() == 0:
        return v
    return _PerRow.apply(v, tuple(x.shape))


def row_values(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-scene v [S] as [rows, 1, ...] for x's scene-major rows (no
    gradient); a 0-d v unchanged."""
    if v.dim() == 0:
        return v
    S = v.shape[0]
    return v.repeat_interleave(x.shape[0] // S).reshape((-1,) + (1,) * (x.dim() - 1))


def scene_rand(gen, device, dtype):
    """draw(shape) = torch.rand(shape) from `gen`; from a list of S
    generators, each scene's shape[0] / S rows from its own, in turn, so
    that each generator draws what its scene alone draws."""
    if isinstance(gen, (list, tuple)):
        S = len(gen)
        return lambda shape: torch.cat([
            torch.rand((shape[0] // S,) + tuple(shape[1:]), generator=g, device=device,
                       dtype=dtype) for g in gen])
    return lambda shape: torch.rand(shape, generator=gen, device=device, dtype=dtype)
