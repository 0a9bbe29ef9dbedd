"""Several Stage-I scenes trained together in one step: the counterpart of
nero_tpu/models/multi_scene.py.

nero_tpu stacks every parameter leaf, the optimizer state and the data on a
leading scene axis and vmaps scene 0's raw step over it, so that each
pallas_call of the step runs once for all scenes. Here the parameters are
stacked the same way (each leaf [S, ...], `jnp.stack`'s layout, which
core/checkpoint.py::save_stacked writes) and one step renders every scene
(parallel/scenes.py): each scene draws its rays [R] from its own generator,
the renderer runs once over the scene-major batch [S R] (the SDF-with-
gradient and the whole-shader kernels launch once each way for all scenes),
each scene's losses are its own, and the step's loss is the sum of the
scenes' totals, so each scene's leaves take that scene's gradient alone.
One Adam runs over the stacked leaves: Adam is per element, so it is S
Adams, as `jax.vmap(opt.init)` is. Scene s is initialised and draws with
seed random_seed + s, and its numbers are those of the scene trained alone
with that seed. The scenes must share the step's configuration and their
images must stack.

With `make_scene_groups` (the ('scene', 'data') layout) a process holds its
one scene (S = 1) and renders that scene's rows of its ray group.
"""
from __future__ import annotations

import torch

from nero_tpu_torch.core.convert import tree_leaves
from nero_tpu_torch.core.device import resolve_device
from nero_tpu_torch.core.trace import span
from nero_tpu_torch.models.shape import NeROShapeModel
from nero_tpu_torch.parallel.mesh import SceneGroups, all_reduce_grads, shard_of
from nero_tpu_torch.parallel.scenes import scene_slice, stack_trees
from nero_tpu_torch.render.rays import sample_ray_batch
from nero_tpu_torch.render.shape import compute_rgb_loss, render
from nero_tpu_torch.train.losses import compute_losses, global_means, total_loss

# what may differ between the scenes of one step (at any depth of the config)
PER_SCENE_KEYS = ("name", "database_name", "random_seed")


def _shared(cfg):
    if isinstance(cfg, dict):
        return {k: _shared(v) for k, v in cfg.items() if k not in PER_SCENE_KEYS}
    if isinstance(cfg, (list, tuple)):
        return [_shared(v) for v in cfg]
    return cfg


class MultiSceneShapeModel:
    """Train several Stage-I scenes in one step; scene s uses seed
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
        self.group = None if groups is None else groups.group
        self.models = {}
        for s in self.scenes:
            cfg = {**cfgs[s], "random_seed": cfgs[s].get("random_seed", 6033) + s}
            self.models[s] = NeROShapeModel(cfg, training=training, device=self.device,
                                            group=self.group)
        if training and groups is None:
            # nero_tpu stacks the scenes' images: equal count and resolution
            shapes = {s: tuple(m.train_data["imgs_u8"].shape) for s, m in self.models.items()}
            if len(set(shapes.values())) > 1:
                raise ValueError(f"the scenes' training images differ in count or size: {shapes}")
        # the scenes held here, stacked on a leading axis (index i: self.scenes[i])
        self.params = stack_trees([self.models[s].params for s in self.scenes])
        first = self.models[self.scenes[0]]
        self.cfg, self.scfg, self.fg_lut = first.cfg, first.scfg, first.fg_lut
        for s in self.scenes:
            # each scene model reads its scene of the stacked leaves
            self.models[s].params = self.scene_params(s)

    def parameters(self) -> list:
        """The stacked leaves."""
        return tree_leaves(self.params)

    def generators(self) -> list:
        """Each scene's batch generator, in the order of the stack."""
        return [self.models[s].gen for s in self.scenes]

    def loss_fn(self, params, batch: dict, step: int, gens, shard=None):
        """(the sum of the scenes' totals, [each scene's total], [each scene's
        log]) of one batch of all scenes' rays, scene-major (`batch` as
        `sample_ray_batch` gives one scene's, the scenes' concatenated)."""
        n = len(self.scenes)
        out = render(params, self.scfg, self.fg_lut, batch["rays_o"], batch["rays_d"],
                     batch["near"], batch["far"], step, gen=gens, is_train=True,
                     human_poses=batch.get("human_poses"), shard=shard)
        with span("nero.step.losses"):
            rgb = batch["rgb"].chunk(n, 0)
            parts = {k: v.chunk(n, 0) for k, v in out.items()}  # per-row keys and [S] values
            totals, logs = [], []
            for i in range(n):
                o = {k: c[i] for k, c in parts.items()}
                o["loss_rgb"] = compute_rgb_loss(o["ray_rgb"], rgb[i], self.cfg["rgb_loss"])
                log = compute_losses(self.cfg["loss"], o, None, step, self.cfg, shard)
                totals.append(total_loss(log, shard))
                logs.append(log)
            return sum(totals), totals, logs

    def train_step(self, optimizer: torch.optim.Optimizer, step: int) -> dict:
        """One step of every scene held here: {scene: its log}."""
        with span("nero.step"):
            shard = shard_of(self.group, self.cfg["train_ray_num"])
            with span("nero.step.sample_rays"):
                batches = []
                for s in self.scenes:
                    m, d = self.models[s], self.models[s].train_data
                    batches.append(sample_ray_batch(m.gen, d["imgs_u8"], d["K_inv"], d["poses"],
                                                    self.cfg["train_ray_num"], d["human_poses"],
                                                    rows=None if shard is None else shard.rows))
                batch = {k: torch.cat([b[k] for b in batches]) for k in batches[0]}
            with span("nero.step.forward"):
                loss, totals, logs = self.loss_fn(self.params, batch, step, self.generators(),
                                                  shard)
            with span("nero.step.optimizer"):
                optimizer.zero_grad(set_to_none=True)
            with span("nero.step.backward"):
                loss.backward()
                if self.group is not None:
                    all_reduce_grads(self.parameters(), self.group)
            with span("nero.step.optimizer"):
                optimizer.step()
            with span("nero.step.log"):
                return {s: {**global_means(log, shard), "loss_total": total.detach()}
                        for s, total, log in zip(self.scenes, totals, logs)}

    @torch.no_grad()
    def scene_params(self, s: int):
        """Scene s's parameters: views of the stacked leaves, no gradient."""
        return scene_slice(self.params, self.scenes.index(s))

    def test_step(self, scene: int, index: int, step: int) -> dict:
        return self.models[scene].test_step(self.scene_params(scene), index, step)

    def num_train_rays_per_step(self) -> int:
        """Rays of one step over the scenes held here."""
        return sum(m.num_train_rays_per_step() for m in self.models.values())
