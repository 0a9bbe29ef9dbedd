"""Train a model from a YAML config on the GPU:

    python -m nero_tpu_torch.run_training --cfg configs/shape/proc/sphere.yaml

`--device cpu` runs the plain PyTorch versions of the kernels instead.

Ray data parallelism over every card of a node, nero_tpu's default of all
devices (one process per card; the global batch is the config's
train_ray_num, split over the ranks):

    torchrun --nproc_per_node=N -m nero_tpu_torch.run_training --cfg ...

Under torchrun with WORLD_SIZE > 1 every rank joins one ray group (NCCL on
the cards, gloo with `--device cpu`); a group that cannot be set up raises.
"""
import argparse

import torch.distributed as dist

from nero_tpu_torch.core.config import load_cfg
from nero_tpu_torch.parallel.mesh import init_from_env, make_data_group
from nero_tpu_torch.train.trainer import Trainer


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", type=str, default="configs/shape/proc/sphere.yaml")
    parser.add_argument("--device", type=str, default=None)
    flags = parser.parse_args(argv)
    device = init_from_env(flags.device)
    if device is None:
        return Trainer(load_cfg(flags.cfg), device=flags.device).run()
    try:
        return Trainer(load_cfg(flags.cfg), device=device, group=make_data_group()).run()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
