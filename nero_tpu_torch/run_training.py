"""Train a model from a YAML config on the GPU:

    python -m nero_tpu_torch.run_training --cfg configs/shape/proc/sphere.yaml

`--device cpu` runs the plain PyTorch versions of the kernels instead.
"""
import argparse

from nero_tpu_torch.core.config import load_cfg
from nero_tpu_torch.train.trainer import Trainer


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", type=str, default="configs/shape/proc/sphere.yaml")
    parser.add_argument("--device", type=str, default=None)
    flags = parser.parse_args(argv)
    Trainer(load_cfg(flags.cfg), device=flags.device).run()


if __name__ == "__main__":
    main()
