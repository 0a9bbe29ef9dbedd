"""What the port's data-parallel tests share: `run_ranks` starts W processes
that join one gloo group through a file under the test's tmp_path, runs one
function of this module in each and returns what each returned; the
functions here run one step of the port in a rank. Imported by its own name
(not through `tests.`), so that the spawned processes import only torch and
the port, never JAX."""
import multiprocessing as mp
import os
import queue
import socket
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

JOIN_TIMEOUT = 120.0   # seconds for the whole group; a hang fails the test
GROUP_TIMEOUT = timedelta(seconds=90)


def _rank_main(fn_name, rank, world, init, args, out):
    try:
        torch.set_num_threads(1)
        if isinstance(init, int):
            # a launcher's environment, as torchrun sets it: the rank joins itself
            os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                              MASTER_ADDR="127.0.0.1", MASTER_PORT=str(init))
            out.put((rank, "ok", globals()[fn_name](rank, world, *args)))
            return
        dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                                world_size=world, timeout=GROUP_TIMEOUT)
        try:
            result = globals()[fn_name](rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, "ok", result))
    except Exception:
        out.put((rank, "error", traceback.format_exc()))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(fn_name: str, world: int, tmp_path, *args, timeout: float = JOIN_TIMEOUT,
              launcher_env: bool = False) -> list:
    """[result of rank 0, ..., rank world-1] of `fn_name(rank, world, *args)`;
    raises with the traceback of a rank that failed or did not finish. The
    ranks join one gloo group through a file, or with `launcher_env` get
    torchrun's variables and a free local port and join by themselves."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    init = (_free_port() if launcher_env else
            os.path.join(str(tmp_path), f"init_{fn_name}_{world}_{time.monotonic_ns()}"))
    procs = [ctx.Process(target=_rank_main, args=(fn_name, r, world, init, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, status, value = out.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise TimeoutError(f"{fn_name}: ranks {sorted(set(range(world)) - set(results))} "
                                   f"did not finish in {timeout} s") from None
            if status != "ok":
                raise RuntimeError(f"{fn_name} rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
    assert not any(p.is_alive() for p in procs)
    return [results[r] for r in range(world)]


def _numpy(log: dict) -> dict:
    return {k: float(v) for k, v in log.items()}


def _grads(params) -> dict:
    from nero_tpu_torch.core.convert import tree_items
    return {k: (np.zeros(tuple(v.shape), np.float32) if v.grad is None
                else v.grad.detach().numpy().copy()) for k, v in tree_items(params)}


def _params(params) -> dict:
    from nero_tpu_torch.core.convert import tree_items
    return {k: v.detach().numpy().copy() for k, v in tree_items(params)}


def shape_step(rank, world, cfg, step, n_slices=1):
    """One Adam step of the Stage-I model on its ray group (every rank of
    the world): (log, gradients after the all-reduce, parameters)."""
    from nero_tpu_torch.models.shape import NeROShapeModel
    from nero_tpu_torch.parallel.mesh import make_data_group

    model = NeROShapeModel(dict(cfg), training=True, device="cpu",
                           group=make_data_group(n_slices=n_slices))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    log = model.train_step(opt, step)
    return _numpy(log), _grads(model.params), _params(model.params)


def shape_loss_and_grads(rank, world, cfg, rays, step, params_np):
    """The Stage-I loss and all-reduced gradients of fixed rays (this rank's
    rows of them) from the given parameters, perturbation off."""
    from nero_tpu_torch.core.convert import from_numpy_tree
    from nero_tpu_torch.models.shape import NeROShapeModel
    from nero_tpu_torch.parallel.mesh import all_reduce_grads, make_data_group, shard_of
    from nero_tpu_torch.render.shape import compute_rgb_loss, render
    from nero_tpu_torch.train.losses import compute_losses, total_loss

    group = make_data_group()
    model = NeROShapeModel(dict(cfg), training=False, device="cpu", group=group)
    model.params = from_numpy_tree(params_np)
    shard = shard_of(group, rays["rays_o"].shape[0])
    b = {k: torch.from_numpy(v[shard.rows]) for k, v in rays.items()}
    out = render(model.params, model.scfg, model.fg_lut, b["rays_o"], b["rays_d"], b["near"],
                 b["far"], step, gen=torch.Generator().manual_seed(0), is_train=True,
                 perturb_overwrite=0.0, human_poses=b["human_poses"], shard=shard)
    out["loss_rgb"] = compute_rgb_loss(out["ray_rgb"], b["rgb"], model.cfg["rgb_loss"])
    loss = total_loss(compute_losses(cfg["loss"], out, None, step, cfg, shard), shard)
    loss.backward()
    all_reduce_grads(model.parameters(), group)
    return float(loss), _grads(model.params)


def material_step(rank, world, cfg, step):
    """One Adam step of the Stage-II model on its ray group: (log,
    gradients after the all-reduce, parameters)."""
    from nero_tpu_torch.models.material import NeROMaterialModel
    from nero_tpu_torch.parallel.mesh import make_data_group

    model = NeROMaterialModel(dict(cfg), training=True, device="cpu", group=make_data_group())
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    log = model.train_step(opt, step)
    return _numpy(log), _grads(model.params), _params(model.params)


def compaction(rank, world, mask, frac):
    """This rank's (compact_src, scatter_to) of its rows of `mask` [rows,
    cols], as global flat indices (the trash row as -1)."""
    from nero_tpu_torch.fields.mc_shading import _compaction
    from nero_tpu_torch.parallel.mesh import make_data_group, shard_of

    shard = shard_of(make_data_group(), mask.shape[0])
    local = torch.from_numpy(mask[shard.rows])
    src, to = _compaction(local.reshape(-1), frac, shard)
    n = local.numel()
    base = shard.rows.start * mask.shape[1]
    to = to.numpy()
    return (src.numpy() + base, np.where(to == n, -1, to + base))


def multi_scene_step(rank, world, cfgs, steps):
    """`steps` steps of the ('scene', 'data') layout: (this rank's scene,
    its per-step logs, its parameters)."""
    from nero_tpu_torch.models.multi_scene import MultiSceneShapeModel
    from nero_tpu_torch.parallel.mesh import make_scene_groups

    groups = make_scene_groups(len(cfgs))
    ms = MultiSceneShapeModel(cfgs, groups=groups, device="cpu")
    opt = torch.optim.Adam(ms.parameters(), lr=1e-3)
    logs = [{k: _numpy(v) for k, v in ms.train_step(opt, i).items()} for i in range(steps)]
    return groups.scene, logs, _params(ms.scene_params(groups.scene))


def sdf_reg(rank, world, norm, sdf, step):
    """The sphere prior of this rank's rows of (norm, sdf) [rows, samples]."""
    from nero_tpu_torch.parallel.mesh import make_data_group, shard_of
    from nero_tpu_torch.train.losses import init_sdf_reg_loss

    shard = shard_of(make_data_group(), norm.shape[0])
    data = {"sdf_pts_norm": torch.from_numpy(norm[shard.rows].reshape(-1)),
            "sdf_vals": torch.from_numpy(sdf[shard.rows].reshape(-1))}
    return {k: float(v) for k, v in init_sdf_reg_loss(data, None, step, {}, shard).items()}


def layouts(rank, world):
    """What each layout gives this rank (4 ranks)."""
    from nero_tpu_torch.parallel import mesh as M

    data, slices = M.make_data_group(), M.make_data_group(n_slices=2)
    scenes = M.make_scene_groups(2)
    rows = M.ray_rows(32, data)
    out = {"data": (data.rank, data.size, data.layout),
           "slices": (slices.rank, slices.size, slices.layout),
           "rows": (rows.start, rows.stop),
           "scene": (scenes.scene, scenes.group.rank, {"scene_of_rank": scenes.scene_of_rank})}
    for key, fn in (("bad_slices", lambda: M.make_data_group(n_slices=3)),
                    ("bad_rows", lambda: M.ray_rows(30, data))):
        try:
            fn()
            out[key] = False
        except ValueError:
            out[key] = True
    return out


def run_training(rank, world, cfg_path):
    """`python -m nero_tpu_torch.run_training --cfg ... --device cpu` in a
    rank that torchrun started: (its train log steps, its validation keys)."""
    from nero_tpu_torch import run_training as entry
    from nero_tpu_torch.train import trainer as T

    runs = []

    class Recording(T.Trainer):
        def run(self):
            runs.append(self)
            return super().run()

    entry.Trainer = Recording
    entry.main(["--cfg", cfg_path, "--device", "cpu"])
    t = runs[0]
    return ([h["step"] for h in t.train_history], sorted(getattr(t, "val_results", {})),
            t.is_main, t.group.size, [h["mfu"] > 0 for h in t.train_history])
