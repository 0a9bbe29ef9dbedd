"""Train a family of Stage-I scenes together: the counterpart of
tools/train_multi_scene.py.

    python -m nero_tpu_torch.train_multi_scene --cfgs configs/shape/syn/*.yaml \\
        [--total_step N] [--model_root data/model] [--log_step 100] [--save_interval 1000]

All scenes advance in one step (models/multi_scene.py): their parameters
stacked on a leading scene axis, one render of every scene's rays with the
SDF-with-gradient and whole-shader kernels launched once each way for all
scenes, one Adam over the stacked leaves, scene 0's learning-rate schedule.
The checkpoint is
`<model_root>/multi_<first three names>[_plusN]/model.npz` in nero_tpu's
stacked layout (core/checkpoint.py::save_stacked); a run resumes from it,
whichever package wrote it. At the end each scene is exported to
`<model_root>/<name>/model.npz`, which the single-scene tools of both
packages read. `--device cpu` runs the plain versions of the kernels.
"""
import argparse
import os
import time


def checkpoint_path(model_root: str, names: list) -> str:
    return os.path.join(model_root, "multi_" + "_".join(names[:3])
                        + (f"_plus{len(names) - 3}" if len(names) > 3 else ""), "model.npz")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfgs", type=str, nargs="+", required=True)
    parser.add_argument("--total_step", type=int, default=None)
    parser.add_argument("--model_root", type=str, default="data/model")
    parser.add_argument("--log_step", type=int, default=100)
    parser.add_argument("--save_interval", type=int, default=1000)
    parser.add_argument("--device", type=str, default=None)
    flags = parser.parse_args(argv)

    import numpy as np

    from nero_tpu_torch.core.checkpoint import load_stacked, save_checkpoint, save_stacked
    from nero_tpu_torch.core.config import load_cfg
    from nero_tpu_torch.core.device import resolve_device
    from nero_tpu_torch.core.logger import Logger, RaysPerSecMeter
    from nero_tpu_torch.models.multi_scene import MultiSceneShapeModel
    from nero_tpu_torch.train.lr import name2lr_schedule
    from nero_tpu_torch.train.trainer import make_optimizer

    device = resolve_device(flags.device)
    cfgs = [load_cfg(p) for p in flags.cfgs]
    names = [c["name"] for c in cfgs]
    total = flags.total_step or cfgs[0].get("total_step", 300000)
    print(f"multi-scene training: {names} for {total} steps on {device}")

    ms = MultiSceneShapeModel(cfgs, device=device)
    lr_cfg = dict(cfgs[0].get("lr_cfg") or {})
    lr_cfg.setdefault("end_iter", total)
    schedule = name2lr_schedule[cfgs[0].get("lr_type", "warm_up_cos")](lr_cfg)
    optimizer, scheduler = make_optimizer(ms.parameters(), "adam", schedule, device)
    generators = ms.generators()

    ckpt_fn = checkpoint_path(flags.model_root, names)
    start_step = 0
    if os.path.exists(ckpt_fn):
        start_step, _ = load_stacked(ckpt_fn, ms.params, optimizer, scheduler, generators)
        # the learning rate as LambdaLR sets it at that position
        for group, base, fn in zip(optimizer.param_groups, scheduler.base_lrs,
                                   scheduler.lr_lambdas):
            group["lr"] = base * fn(scheduler.last_epoch)
        print(f"resumed from step {start_step}")

    logger = Logger(os.path.dirname(ckpt_fn))
    meter = RaysPerSecMeter(device)
    rays_per_step = ms.num_train_rays_per_step()
    meter.sync(start_step, rays_per_step)
    history = []
    t0 = time.time()
    for step in range(start_step, total):
        logs = ms.train_step(optimizer, step)
        scheduler.step()
        if (step + 1) % flags.log_step == 0:
            losses = np.asarray([float(logs[s]["loss_total"]) for s in ms.scenes])
            meter.sync(step + 1, rays_per_step)
            scalars = {"rays_per_sec": meter.rays_per_sec}
            for s, loss in zip(ms.scenes, losses):
                scalars[f"{names[s]}/loss_total"] = float(loss)
            logger.log(scalars, "train", step + 1)
            history.append({"step": step, **scalars})
            print(f"step {step + 1}: mean loss {losses.mean():.4f} "
                  f"({meter.rays_per_sec:.0f} rays/s aggregate)")
        if (step + 1) % flags.save_interval == 0 or (step + 1) == total:
            save_stacked(ckpt_fn, step + 1, 0.0, ms.params, optimizer,
                         scheduler.last_epoch, generators)

    print(f"done in {time.time() - t0:.0f}s; checkpoint at {ckpt_fn}")
    # per-scene checkpoints for the single-scene tools
    exports = []
    for s in ms.scenes:
        fn = os.path.join(flags.model_root, names[s], "model.npz")
        save_checkpoint(fn, total, 0.0, ms.scene_params(s))
        exports.append(fn)
        print(f"exported {fn}")
    return {"checkpoint": ckpt_fn, "exports": exports, "history": history, "model": ms,
            "optimizer": optimizer}


if __name__ == "__main__":
    main()
