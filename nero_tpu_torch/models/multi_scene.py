"""Several Stage-I scenes trained together: the counterpart of
nero_tpu/models/multi_scene.py.

nero_tpu vmaps scene 0's raw step over a leading scene axis of parameters,
optimizer state and data, so the scenes must share the step's configuration
and their data must stack. Here the scenes are S `NeROShapeModel`s stepped
one after another on the process's device (a kernel takes one weight set a
launch), with one Adam over every scene's leaves: Adam is per element and
each scene's step updates only the leaves that carry gradients, so it is S
Adams, as `jax.vmap(opt.init)` is. Scene s is initialised and draws its
batches with seed random_seed + s, so it trains as the scene alone with that
seed does.

With `make_scene_groups` (the ('scene', 'data') layout) a process trains
only its scene, on that scene's ray group.
"""
from __future__ import annotations

import torch

from nero_tpu_torch.core.convert import tree_leaves
from nero_tpu_torch.core.device import resolve_device
from nero_tpu_torch.models.shape import NeROShapeModel
from nero_tpu_torch.parallel.mesh import SceneGroups

# what may differ between the scenes of one step (at any depth of the config)
PER_SCENE_KEYS = ("name", "database_name", "random_seed")


def _shared(cfg):
    if isinstance(cfg, dict):
        return {k: _shared(v) for k, v in cfg.items() if k not in PER_SCENE_KEYS}
    if isinstance(cfg, (list, tuple)):
        return [_shared(v) for v in cfg]
    return cfg


class MultiSceneShapeModel:
    """Train several Stage-I scenes together; scene s uses seed
    random_seed + s."""

    def __init__(self, cfgs: list[dict], groups: SceneGroups | None = None,
                 training: bool = True, device=None):
        if not cfgs:
            raise ValueError("no scene")
        for s, cfg in enumerate(cfgs[1:], 1):
            if _shared(cfg) != _shared(cfgs[0]):
                raise ValueError(f"scene {s} ({cfg.get('name')}) differs from scene 0 in more "
                                 f"than {PER_SCENE_KEYS}: the scenes share one step")
        if groups is not None and groups.n_scenes != len(cfgs):
            raise ValueError(f"{groups.n_scenes} scene groups for {len(cfgs)} scenes")
        self.device = resolve_device(device)
        self.n_scenes = len(cfgs)
        self.names = [c["name"] for c in cfgs]
        self.scenes = list(range(self.n_scenes)) if groups is None else [groups.scene]
        group = None if groups is None else groups.group
        self.models = {}
        for s in self.scenes:
            cfg = {**cfgs[s], "random_seed": cfgs[s].get("random_seed", 6033) + s}
            self.models[s] = NeROShapeModel(cfg, training=training, device=self.device,
                                            group=group)
        if training and groups is None:
            # nero_tpu stacks the scenes' images: equal count and resolution
            shapes = {s: tuple(m.train_data["imgs_u8"].shape) for s, m in self.models.items()}
            if len(set(shapes.values())) > 1:
                raise ValueError(f"the scenes' training images differ in count or size: {shapes}")

    def parameters(self) -> list:
        """Every leaf of every scene held here, scene by scene."""
        return [p for s in self.scenes for p in tree_leaves(self.models[s].params)]

    def train_step(self, optimizer: torch.optim.Optimizer, step: int) -> dict:
        """One step of every scene held here, in turn: {scene: its log}."""
        return {s: self.models[s].train_step(optimizer, step) for s in self.scenes}

    def scene_params(self, s: int):
        return self.models[s].params

    def test_step(self, scene: int, index: int, step: int) -> dict:
        return self.models[scene].test_step(self.models[scene].params, index, step)

    def num_train_rays_per_step(self) -> int:
        """Rays of one step over the scenes held here."""
        return sum(m.num_train_rays_per_step() for m in self.models.values())
