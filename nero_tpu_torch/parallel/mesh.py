"""Ray data parallelism over torch.distributed: the counterpart of
nero_tpu/parallel/mesh.py.

nero_tpu shards the ray batch over a device mesh and lets GSPMD compute the
global function: every layout gives the step that one device gives. Here
each process (one per card, started by torchrun) renders a contiguous block
of the global batch's rows, and the step stays the global one:

  * every random draw is of the global batch's shape, from a generator that
    every rank holds in the same state, then cut to the rank's rows
    (`draw_rows`): the generators stay in step and the draws are one
    process's draws;
  * every reduction over rows is global (`sum_rows`, `mean_rows`), taken
    before any nonlinearity that follows it;
  * the gradients are all-reduced in one flat bucket (`all_reduce_grads`)
    before the optimizer step, so every rank holds the same parameters.

Layouts, with nero_tpu's axis names:

  * ('data',): ray DP over a group of ranks (`make_data_group`);
  * ('slice', 'data'): the multi-slice layout (`n_slices` > 1). NCCL builds
    its own hierarchy (NVLink within a node, the network across nodes), so
    `n_slices` changes the recorded layout and not the result;
  * ('scene', 'data'): independent scenes, each on its own ray group
    (`make_scene_groups`); scenes never communicate.

nero_tpu caps its default mesh with NERO_MESH_DEVICES for its tests; here
the launcher's `--nproc_per_node` sets the number of ranks, so there is no
such variable.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import NamedTuple

import torch
import torch.distributed as dist

from nero_tpu_torch.core.device import resolve_device

DATA_AXIS = "data"
SCENE_AXIS = "scene"
SLICE_AXIS = "slice"

DEFAULT_TIMEOUT = timedelta(minutes=30)


def init_from_env(device=None, timeout: timedelta = DEFAULT_TIMEOUT,
                  force: bool = False) -> torch.device | None:
    """Join the process group that torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL on CUDA (`cuda:LOCAL_RANK`),
    gloo on the CPU (`device="cpu"`). Returns this rank's device, or None
    when no launcher set WORLD_SIZE, or set it to 1 and `force` is off: then
    nothing changes. A group that cannot be initialised raises."""
    world = os.environ.get("WORLD_SIZE")
    if world is None or (int(world) == 1 and not force):
        return None
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = resolve_device(f"cuda:{local}" if device is None else device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                rank=int(os.environ["RANK"]), world_size=int(world),
                                timeout=timeout)
    return dev


class DataGroup(NamedTuple):
    """A ray group: its process group (None = the default group), this
    rank's index in it, its size, its global ranks and its layout."""
    group: object
    rank: int
    size: int
    ranks: tuple
    layout: dict


def _world_ranks(ranks) -> tuple:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_from_env or init_process_group first")
    return tuple(range(dist.get_world_size())) if ranks is None else tuple(ranks)


def _data_group(ranks: tuple, pg, layout: dict) -> DataGroup:
    me = dist.get_rank()
    return DataGroup(pg, ranks.index(me) if me in ranks else -1, len(ranks), ranks, layout)


def make_data_group(ranks=None, n_slices: int = 1) -> DataGroup:
    """The ('data',) ray group over `ranks` (default: every rank), or with
    n_slices > 1 the ('slice', 'data') layout, whose size n_slices must
    divide. Every rank of the default group must call it (dist.new_group)."""
    ranks = _world_ranks(ranks)
    if n_slices < 1 or len(ranks) % n_slices:
        raise ValueError(f"{n_slices} slices do not divide {len(ranks)} ranks")
    pg = None if ranks == tuple(range(dist.get_world_size())) else dist.new_group(list(ranks))
    layout = ({SLICE_AXIS: n_slices, DATA_AXIS: len(ranks) // n_slices} if n_slices > 1
              else {DATA_AXIS: len(ranks)})
    return _data_group(ranks, pg, layout)


class SceneGroups(NamedTuple):
    """The ('scene', 'data') layout: one ray group per scene; `scene` is
    this rank's scene and `group` its ray group."""
    scene: int
    group: DataGroup
    n_scenes: int
    scene_of_rank: dict


def make_scene_groups(n_scenes: int, ranks=None) -> SceneGroups:
    """Scenes on the outer axis, ray DP within each scene's block of
    consecutive ranks. Every rank of the default group must call it."""
    ranks = _world_ranks(ranks)
    if n_scenes < 1 or len(ranks) % n_scenes:
        raise ValueError(f"{n_scenes} scenes do not divide {len(ranks)} ranks")
    per = len(ranks) // n_scenes
    blocks = [ranks[s * per:(s + 1) * per] for s in range(n_scenes)]
    groups = [_data_group(b, dist.new_group(list(b)), {DATA_AXIS: per}) for b in blocks]
    scene_of_rank = {r: s for s, b in enumerate(blocks) for r in b}
    me = scene_of_rank.get(dist.get_rank())
    if me is None:
        raise ValueError(f"rank {dist.get_rank()} is not among {ranks}")
    return SceneGroups(me, groups[me], n_scenes, scene_of_rank)


def ray_rows(n_global: int, group: DataGroup) -> slice:
    """This rank's contiguous rows of a global batch of n_global rows, as
    P('data') shards the leading axis: equal blocks in rank order."""
    if n_global % group.size:
        raise ValueError(f"{n_global} rows do not split over {group.size} ranks")
    per = n_global // group.size
    return slice(group.rank * per, (group.rank + 1) * per)


class RayShard(NamedTuple):
    """This rank's rows of one global batch of `n` rows."""
    group: DataGroup
    n: int
    rows: slice

    @property
    def n_local(self) -> int:
        return self.rows.stop - self.rows.start


def shard_of(group: DataGroup | None, n_global: int) -> RayShard | None:
    """The shard of a global batch of n_global rows (None without a group)."""
    return None if group is None else RayShard(group, n_global, ray_rows(n_global, group))


class _GlobalSum(torch.autograd.Function):
    """all_reduce(SUM) whose backward all-reduces the cotangent, as
    torch.distributed.nn.functional.all_reduce does (which recent torch
    deprecates). Every rank then holds size x the gradient of the one global
    loss, and `all_reduce_grads` averages."""

    @staticmethod
    def forward(ctx, pg, x):
        ctx.pg = pg
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=pg)
        return x

    @staticmethod
    def backward(ctx, g):
        return None, _GlobalSum.apply(ctx.pg, g)


def global_sum(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """The sum of `x` over the group's ranks, differentiable."""
    return _GlobalSum.apply(group.group, x)


def sum_rows(x: torch.Tensor, shard: RayShard | None) -> torch.Tensor:
    """A sum over the rows of this rank, made global (x itself without a shard)."""
    return x if shard is None else global_sum(x, shard.group)


def mean_rows(x: torch.Tensor, shard: RayShard | None) -> torch.Tensor:
    """The mean of a per-row tensor over the global batch: each rank's mean
    weighted by its share of the rows, summed. With one rank the weight is
    1.0, so the bits are those of `x.mean()`."""
    if shard is None:
        return x.mean()
    return global_sum(x.mean() * (shard.n_local / shard.n), shard.group)


def draw_rows(draw, shape: tuple, shard: RayShard | None) -> torch.Tensor:
    """`draw(shape)` as one process draws it: of the global batch's shape,
    then this rank's rows. `shape[0]` is the local row count."""
    if shard is None:
        return draw(shape)
    return draw((shard.n, *shape[1:]))[shard.rows]


def rank_offset(count: torch.Tensor, shard: RayShard) -> torch.Tensor:
    """The number of selected entries on the ranks before this one, from
    each rank's `count` (a 0-d integer tensor): the all-gathered W-vector of
    counts, summed below this rank."""
    counts = torch.zeros(shard.group.size, dtype=count.dtype, device=count.device)
    counts[shard.group.rank] = count
    dist.all_reduce(counts, group=shard.group.group)
    return counts[:shard.group.rank].sum()


@torch.no_grad()
def all_reduce_grads(params, group: DataGroup) -> None:
    """Average the gradients of `params` (a list of leaves) over the group:
    one flat bucket, one all_reduce. Each rank's gradient is size x its
    share (`_GlobalSum`), so the average is the global loss's gradient."""
    leaves = [p for p in params if p.grad is not None]
    if not leaves:
        return
    bucket = torch.cat([p.grad.reshape(-1) for p in leaves])
    dist.all_reduce(bucket, group=group.group)
    if group.size > 1:
        bucket /= group.size
    i = 0
    for p in leaves:
        n = p.grad.numel()
        p.grad.copy_(bucket[i:i + n].view_as(p.grad))
        i += n
