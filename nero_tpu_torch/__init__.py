"""nero_tpu_torch: the PyTorch + CUDA (Hopper) port of nero_tpu.

The JAX package `nero_tpu` stays the reference; this package imports nothing
from it and nothing of JAX. Its layout mirrors `nero_tpu` so each module's
counterpart is easy to find. Entry points run on CUDA unless the caller
passes `device="cpu"` (the tests do).

It covers Stage-I shape training in all its configurations and Stage-II
material training, on the procedural scenes:
`python -m nero_tpu_torch.run_training --cfg configs/shape/proc/sphere.yaml`
(also `sphere_real.yaml`, `sphere_heads.yaml`, `configs/material/proc/*.yaml`).
"""
