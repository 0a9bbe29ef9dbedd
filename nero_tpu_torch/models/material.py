"""Stage-II material model: fixed mesh + traced visibility + MC BRDF estimation.

Counterpart of nero_tpu/models/material.py: load the Stage-I mesh, build the
tracer, precompute the first hit of every training pixel once on the host
(keeping only hits), then per step shade 512 surface points with the
Monte-Carlo GGX shader; validation shades only the hit pixels of a test
view, scattered back into the image.

  * the one-time all-pixel trace, the hemisphere hit-rate estimate and the
    validation views' primary rays run on the exact host tracer (C++,
    OpenMP): precompute, not the training hot path;
  * the hit store lives on the device and each step draws its batch there
    with the model's `torch.Generator`: no per-step host-to-device copy;
  * the per-step hot path (512 points x 768 directions: visibility + light
    MLPs + BRDF) traces through the configured backend: `neural`
    (`geometry/neural_tracer.py`, whose march is a kernel on the card),
    `grid` (`geometry/grid_tracer.py`) or `bvh` (the device traversal of
    `geometry/bvh.py`). Where the distilled field's near-band RMS exceeds
    `tracer_rms_fallback`, the mesh is too hard for the neural tracer and
    the model switches to the grid tracer, and says so.

With a ray group (`group`, parallel/mesh.py::make_data_group) the step is
nero_tpu's step over a data mesh (models/material.py:322-360 with
constrain_rays): every rank draws the global batch's indices, shades its
rows with global draws, global compaction and global loss reductions, and
all-reduces the gradients before the optimizer step.
"""
from __future__ import annotations

import numpy as np
import torch

from nero_tpu_torch.core.convert import tree_leaves
from nero_tpu_torch.core.device import resolve_device
from nero_tpu_torch.dataset.database import get_database_split, parse_database_name
from nero_tpu_torch.fields.mc_shading import (MCShadingConfig, env_light_image,
                                              init_mc_shading, make_direction_samples,
                                              material_regularization, mc_config_from_dict,
                                              mc_shading_apply, predict_materials_mc)
from nero_tpu_torch.geometry.mesh_io import read_ply
from nero_tpu_torch.models.shape import build_imgs_info
from nero_tpu_torch.parallel.mesh import DataGroup, RayShard, all_reduce_grads, shard_of
from nero_tpu_torch.render.rays import human_coordinate_poses
from nero_tpu_torch.render.shape import compute_rgb_loss
from nero_tpu_torch.train.losses import compute_losses, global_means, total_loss

DEFAULT_MATERIAL_CFG = {
    "train_ray_num": 512,
    "test_ray_num": 1024,
    "database_name": "proc/sphere/64",
    "rgb_loss": "charbonier",
    "mesh": "data/meshes/bear_shape-300000.ply",
    "shader_cfg": {},
    "reg_mat": True,
    "reg_diffuse_light": True,
    "reg_diffuse_light_lambda": 0.1,
    "fixed_camera": False,
    "random_seed": 6033,
    "loss": ["nerf_render", "mat_reg"],
    # visibility backend: 'neural' (distilled SDF field, marched on the
    # tensor cores: the default), 'grid' (baked SDF grid, sphere-traced),
    # 'bvh' (exact device wavefront; slow, for small meshes and debugging)
    "tracer": "neural",
    "tracer_distill_steps": 3000,
    "tracer_n_coarse": 32,
    # 'sphere' = fixed n_sphere-iteration sphere trace of the distilled SDF
    # (ops/sphere_march.py); 'uniform' = fixed n_coarse-sample scan
    # (ops/march.py; set tracer_n_refine to 8 with it)
    "tracer_march_mode": "sphere",
    "tracer_n_sphere": 18,
    # bracket refinement after the march: 'illinois' (bracketed regula
    # falsi: 2 evaluations + a free final secant) or 'bisect'; sphere march
    # only, the uniform march always bisects
    "tracer_refine_mode": "illinois",
    "tracer_n_refine": 2,
    # distilled-field topology: 'std' (PE6 -> 4 x 128) or 'wide' (a finer
    # 123-channel encoding, one hidden layer fewer)
    "tracer_field_topology": "std",
    # if the distilled field's near-band RMS exceeds this, the mesh is too
    # hard for the neural tracer: fall back to the grid tracer and say so
    # loudly (visibility errors silently poison Stage II otherwise)
    "tracer_rms_fallback": 0.004,
    # hit-compacted inner-light evaluation: 'auto' measures the scene's
    # hemisphere hit rate at init and sizes the static hit capacity with
    # 1.5x headroom; a float fixes the fraction; 'off' evaluates the
    # inner-light MLP on every sample direction
    "inner_compact": "auto",
    # miss-compacted outer-light evaluation, the concave-scene mirror of
    # inner_compact; train-only
    "outer_compact": "auto",
}

_SHADE_KEYS = {"rgb_pr": 3, "specular_light": 3, "specular_color": 3, "diffuse_light": 3,
               "diffuse_color": 3, "albedo": 3, "metallic": 1, "roughness": 1}


class NeROMaterialModel:
    def __init__(self, cfg: dict, training: bool = True, device=None,
                 group: DataGroup | None = None):
        self.cfg = {**DEFAULT_MATERIAL_CFG, **cfg}
        self.device = resolve_device(device)
        self.group = group
        shader_cfg = dict(self.cfg.get("shader_cfg") or {})
        shader_cfg["is_real"] = self.cfg["database_name"].startswith("real")
        # bf16_hidden as it resolves on this device
        self.mcfg: MCShadingConfig = mc_config_from_dict(shader_cfg).resolved(self.device)
        seed = self.cfg["random_seed"]
        self.params = init_mc_shading(torch.Generator().manual_seed(seed), self.mcfg,
                                      device=self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.samples = make_direction_samples(self.mcfg, device=self.device)
        self._init_geometry()
        if training:
            self._init_dataset()

    def parameters(self) -> list:
        return tree_leaves(self.params)

    # -------------------------------------------------------------- geometry
    def _init_geometry(self):
        mesh_data = read_ply(self.cfg["mesh"]) if isinstance(self.cfg["mesh"], str) \
            else self.cfg["mesh"]
        self.vertices = np.asarray(mesh_data["vertices"], np.float32)
        self.triangles = np.asarray(mesh_data["triangles"], np.int32)
        backend = self.cfg["tracer"]
        if backend == "neural":
            from nero_tpu_torch.geometry.neural_tracer import NeuralTracer
            self.ray_tracer = NeuralTracer(
                self.vertices, self.triangles,
                distill_steps=self.cfg["tracer_distill_steps"],
                n_coarse=self.cfg["tracer_n_coarse"],
                march_mode=self.cfg["tracer_march_mode"],
                n_sphere=self.cfg["tracer_n_sphere"],
                n_refine=self.cfg["tracer_n_refine"],
                refine_mode=self.cfg["tracer_refine_mode"],
                field_topology=self.cfg["tracer_field_topology"],
                seed=self.cfg["random_seed"], device=self.device)
            threshold = self.cfg["tracer_rms_fallback"]
            if self.ray_tracer.distill_rms > threshold:
                print(f"[NeROMaterialModel] WARNING: neural tracer distill RMS "
                      f"{self.ray_tracer.distill_rms:.4f} > {threshold}: falling back to "
                      f"the grid tracer for this mesh")
                backend = "grid"
        if backend == "grid":
            from nero_tpu_torch.geometry.grid_tracer import GridTracer
            self.ray_tracer = GridTracer(self.vertices, self.triangles, device=self.device)
        elif backend == "bvh":
            from nero_tpu_torch.geometry.bvh import RayTracer
            self.ray_tracer = RayTracer(self.vertices, self.triangles, device=self.device)
        elif backend != "neural":
            raise NotImplementedError(f"tracer backend {backend}")
        self.trace_fn = self.ray_tracer.trace_fn()

    # ---------------------------------------------------------------- dataset
    def _init_dataset(self):
        self.database = parse_database_name(self.cfg["database_name"])
        self.train_ids, self.test_ids = get_database_split(self.database, "validation")
        info = build_imgs_info(self.database, self.train_ids)
        self.train_batch = self._construct_hit_batch(info)
        self.tbn = len(self.train_batch["rays_o"])
        # the same one-time shuffle as nero_tpu, so that both packages hold
        # the same store and estimate the hit rate on the same points
        idx = np.random.RandomState(self.cfg["random_seed"]).permutation(self.tbn)
        self.train_batch = {k: v[idx] for k, v in self.train_batch.items()}
        # device-resident hit store: the step draws its batch on the device
        self.train_data = {k: torch.as_tensor(v, device=self.device)
                           for k, v in self.train_batch.items()}
        self.test_imgs_info = build_imgs_info(self.database, self.test_ids)
        self._resolve_inner_compact()
        self._resolve_outer_compact()

    def _resolve_inner_compact(self):
        """Size the static hit capacity of the compacted inner-light path:
        the scene's hemisphere hit rate on real surface points (exact host
        tracer) with 1.5x headroom. An explicit shader_cfg.inner_compact_frac
        wins."""
        if (self.cfg.get("shader_cfg") or {}).get("inner_compact_frac") is not None:
            return
        mode = self.cfg["inner_compact"]
        if mode in (0, 0.0, "off", False, None):
            return
        frac = float(mode) if mode != "auto" else None
        if frac is None:
            rate = self._estimate_hit_rate()
            frac = min(0.75, 1.5 * rate + 0.05)
            if frac >= 0.72:
                print(f"[NeROMaterialModel] inner_compact auto: hemisphere hit "
                      f"rate {rate:.3f} too high for compaction — keeping the "
                      f"full-lattice inner-light path")
                return
            print(f"[NeROMaterialModel] inner_compact auto: hemisphere hit rate "
                  f"{rate:.3f} -> inner-light capacity {frac:.3f} of sample dirs")
        self.mcfg = self.mcfg._replace(inner_compact_frac=frac)

    def _resolve_outer_compact(self):
        """Size the static MISS capacity of the compacted outer-light path
        (concave scenes): 1.5x the sample-weighted miss rate + 0.05, engaged
        only when that saves >= 25% of the outer evaluations. An explicit
        shader_cfg.outer_compact_frac wins. Train-only."""
        if (self.cfg.get("shader_cfg") or {}).get("outer_compact_frac") is not None:
            return
        mode = self.cfg["outer_compact"]
        if mode in (0, 0.0, "off", False, None):
            return
        frac = float(mode) if mode != "auto" else None
        if frac is None:
            miss_rate = 1.0 - self._estimate_hit_rate(reduce="weighted")
            frac = min(0.75, 1.5 * miss_rate + 0.05)
            if frac >= 0.72:
                return  # mostly-miss scene (convex): compaction saves nothing
            print(f"[NeROMaterialModel] outer_compact auto: hemisphere miss "
                  f"rate {miss_rate:.3f} -> outer-light capacity {frac:.3f} "
                  f"of sample dirs")
        self.mcfg = self.mcfg._replace(outer_compact_frac=frac)

    def _estimate_hit_rate(self, n_pts: int = 256, n_dirs: int = 64,
                           reduce: str = "max") -> float:
        """Hemisphere self-hit rate: cosine dirs + mirror dirs from a sample
        of real surface points, traced with the exact host tracer. 'max'
        bounds the hit count (inner capacity), 'weighted' is the
        sample-weighted mean of the two direction families."""
        rng = np.random.RandomState(0)
        idx = rng.choice(self.tbn, min(n_pts, self.tbn), replace=False)
        pts = self.train_batch["inters"][idx]
        normals = self.train_batch["normals"][idx]
        normals = normals / np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-12)
        view = -self.train_batch["rays_d"][idx]
        refl = np.sum(view * normals, -1, keepdims=True) * normals * 2 - view

        # cosine-hemisphere dirs about each normal
        u = rng.rand(len(pts), n_dirs, 2)
        phi = 2 * np.pi * u[..., 0]
        st = np.sqrt(u[..., 1])
        ct = np.sqrt(1 - u[..., 1])
        local = np.stack([np.cos(phi) * st, np.sin(phi) * st, ct], -1)
        a = np.where(np.abs(normals[:, :1]) < 0.9,
                     np.array([[1.0, 0, 0]]), np.array([[0, 1.0, 0]]))
        t1 = np.cross(normals, a)
        t1 /= np.maximum(np.linalg.norm(t1, axis=-1, keepdims=True), 1e-12)
        t2 = np.cross(normals, t1)
        dirs_d = (local[..., :1] * t1[:, None] + local[..., 1:2] * t2[:, None]
                  + local[..., 2:] * normals[:, None])
        # mirror dirs with a small jitter (specular lobes concentrate here)
        jit = rng.randn(len(pts), n_dirs, 3).astype(np.float32) * 0.1
        dirs_s = refl[:, None] + jit
        dirs_s /= np.maximum(np.linalg.norm(dirs_s, axis=-1, keepdims=True), 1e-12)

        rates = []
        for dirs in (dirs_d, dirs_s):
            o = (pts[:, None] + dirs * 1e-5).reshape(-1, 3).astype(np.float32)
            d = dirs.reshape(-1, 3).astype(np.float32)
            _, _, _, hit = self.ray_tracer.trace_cpu(o, d)
            rates.append(float(np.mean(hit)))
        if reduce == "weighted":
            dn = self.mcfg.diffuse_sample_num
            sn = self.mcfg.specular_sample_num
            return (dn * rates[0] + sn * rates[1]) / (dn + sn)
        return max(rates) if reduce == "max" else min(rates)

    def _image_rays_np(self, K, pose, h, w):
        xs, ys = np.meshgrid(np.arange(w, dtype=np.float32) + 0.5,
                             np.arange(h, dtype=np.float32) + 0.5)
        coords = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3)
        d_cam = coords @ np.linalg.inv(K).T
        R, t = pose[:, :3], pose[:, 3]
        rays_d = d_cam @ R
        rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
        rays_o = np.broadcast_to(-R.T @ t, rays_d.shape).astype(np.float32)
        return rays_o.astype(np.float32), rays_d.astype(np.float32)

    def _human_poses_np(self, poses: np.ndarray) -> np.ndarray:
        return human_coordinate_poses(torch.as_tensor(poses), self.cfg["fixed_camera"]).numpy()

    def _construct_hit_batch(self, info) -> dict:
        """Trace every train pixel once on the host, keep the hits."""
        n, h, w, _ = info["imgs"].shape
        human = self._human_poses_np(info["poses"])
        out = {k: [] for k in ["rays_o", "rays_d", "inters", "normals", "depth",
                               "human_poses", "rgb"]}
        for i in range(n):
            rays_o, rays_d = self._image_rays_np(info["Ks"][i], info["poses"][i], h, w)
            inters, normals, depth, hit = self.ray_tracer.trace_cpu(rays_o, rays_d)
            normals = -normals  # NeuS flip
            rgb = info["imgs"][i].reshape(-1, 3).astype(np.float32) / 255.0
            out["rays_o"].append(rays_o[hit])
            out["rays_d"].append(rays_d[hit])
            out["inters"].append(inters[hit])
            out["normals"].append(normals[hit])
            out["depth"].append(depth[hit, None])
            out["human_poses"].append(np.broadcast_to(human[i], (h * w, 3, 4))[hit])
            out["rgb"].append(rgb[hit])
        batch = {k: np.concatenate(v, 0) for k, v in out.items()}
        n_hits = len(batch["rays_o"])
        rn = self.cfg["train_ray_num"]
        if 0 < n_hits < rn:
            # tiny scenes: tile the hit buffer up to one full batch
            reps = -(-rn // n_hits)
            batch = {k: np.concatenate([v] * reps, 0)[:rn] for k, v in batch.items()}
        return batch

    # -------------------------------------------------------------- training
    def sample_batch(self, gen: torch.Generator, shard: RayShard | None = None) -> dict:
        """A uniform random batch of the device-resident hit store (with
        `shard`, this rank's rows of it)."""
        n = self.train_data["rays_o"].shape[0]
        idx = torch.randint(0, n, (self.cfg["train_ray_num"],), generator=gen,
                            device=self.device)
        if shard is not None:
            idx = idx[shard.rows]
        return {k: v[idx] for k, v in self.train_data.items()}

    def shade(self, params, batch: dict, gen: torch.Generator | None,
              shard: RayShard | None = None):
        """(colors [n,3], outputs) of the batch's surface points; `gen` draws
        the azimuth rotations (None: the fixed lattice)."""
        return mc_shading_apply(params, self.mcfg, self.samples, self.trace_fn,
                                batch["inters"], -batch["rays_d"], batch["normals"],
                                batch["human_poses"], gen=gen, shard=shard)

    def loss_fn(self, params, batch: dict, step: int, gen: torch.Generator,
                shard: RayShard | None = None):
        """(total loss, log dict) of one shaded batch; with `shard`, of this
        rank's rows, the total over the global batch."""
        cfg = self.cfg
        colors, outputs = self.shade(params, batch, gen, shard)
        out = dict(outputs)
        out["loss_rgb"] = compute_rgb_loss(colors, batch["rgb"], cfg["rgb_loss"])
        if cfg["reg_mat"]:
            out["loss_mat_reg"] = material_regularization(
                params, self.mcfg, gen, batch["inters"], batch["normals"], outputs["metallic"],
                outputs["roughness"], outputs["albedo"], step, shard=shard)
        if cfg["reg_diffuse_light"]:
            dl = outputs["diffuse_light"]
            out["loss_diffuse_light"] = (
                torch.sum(torch.abs(dl - torch.mean(dl, dim=-1, keepdim=True)), -1)
                * cfg["reg_diffuse_light_lambda"])
        log = compute_losses(cfg["loss"], out, None, step, cfg, shard)
        return total_loss(log, shard), log

    def train_step(self, optimizer: torch.optim.Optimizer, step: int) -> dict:
        """Draw a batch, shade, back-propagate, update. Returns the log
        (device tensors; reading them synchronises)."""
        shard = shard_of(self.group, self.cfg["train_ray_num"])
        batch = self.sample_batch(self.gen, shard)
        loss, log = self.loss_fn(self.params, batch, step, self.gen, shard)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.group is not None:
            all_reduce_grads(self.parameters(), self.group)
        optimizer.step()
        log = global_means(log, shard)
        log["loss_total"] = loss.detach()
        return log

    # ------------------------------------------------------------ validation
    @torch.no_grad()
    def shade_chunk(self, params, pts, view_dirs, normals, human_poses) -> dict:
        """Validation renders always shade the full lattice (approximations
        train, never evaluate) on the fixed direction lattice."""
        mcfg = self.mcfg._replace(inner_compact_frac=0.0, outer_compact_frac=0.0)
        colors, outputs = mc_shading_apply(params, mcfg, self.samples, self.trace_fn, pts,
                                           view_dirs, normals, human_poses, gen=None)
        out = {k: outputs[k] for k in _SHADE_KEYS if k != "rgb_pr"}
        out["rgb_pr"] = colors
        return out

    def test_step(self, params, index: int, step: int = 0) -> dict:
        info = {k: v[index:index + 1] for k, v in self.test_imgs_info.items()}
        h, w = info["imgs"].shape[1:3]
        rays_o, rays_d = self._image_rays_np(info["Ks"][0], info["poses"][0], h, w)
        inters, normals, depth, hit = self.ray_tracer.trace_cpu(rays_o, rays_d)
        normals = -normals
        human = self._human_poses_np(info["poses"])[0]
        rgb_gt = info["imgs"][0].reshape(-1, 3).astype(np.float32) / 255.0

        outputs = {k: np.zeros((h * w, d), np.float32) for k, d in _SHADE_KEYS.items()}
        as_image = lambda out: {
            k: (v.reshape(h, w, -1) if v.ndim == 2 and v.shape[0] == h * w else v)
            for k, v in out.items()}

        hit_idx = np.nonzero(hit)[0]
        if len(hit_idx) == 0:  # view misses the object entirely
            outputs["rgb_gt"] = np.zeros((h * w, 3), np.float32)
            outputs["loss_rgb"] = np.zeros((h * w,), np.float32)
            return as_image(outputs)
        trn = self.cfg["test_ray_num"]
        to_dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=self.device)
        for ci in range(0, len(hit_idx), trn):
            sel = hit_idx[ci:ci + trn]
            n_pad = trn - len(sel)   # fixed chunk shape, as the JAX package pads
            sel_pad = np.concatenate([sel, np.repeat(sel[-1:], n_pad)]) if n_pad else sel
            res = self.shade_chunk(params, to_dev(inters[sel_pad]), to_dev(-rays_d[sel_pad]),
                                   to_dev(normals[sel_pad]),
                                   to_dev(np.broadcast_to(human, (len(sel_pad), 3, 4))))
            for k in _SHADE_KEYS:
                outputs[k][sel] = res[k][:len(sel)].cpu().numpy()
        # squared-roughness convention -> sqrt for display
        outputs["roughness"] = np.sqrt(np.maximum(outputs["roughness"], 0.0))
        outputs["rgb_gt"] = np.where(hit[:, None], rgb_gt, 0.0)
        outputs["loss_rgb"] = compute_rgb_loss(torch.as_tensor(outputs["rgb_pr"]),
                                               torch.as_tensor(outputs["rgb_gt"]),
                                               self.cfg["rgb_loss"]).numpy()
        return as_image(outputs)

    # -------------------------------------------------------------- material
    @torch.no_grad()
    def predict_materials(self, params=None, batch_size: int = 8192) -> dict:
        """Per-vertex materials; roughness exported as sqrt."""
        params = self.params if params is None else params
        metallic, roughness, albedo = [], [], []
        for vi in range(0, len(self.vertices), batch_size):
            chunk = torch.as_tensor(self.vertices[vi:vi + batch_size], device=self.device)
            m, r, a = predict_materials_mc(params, chunk)
            metallic.append(m.cpu().numpy())
            roughness.append(np.sqrt(np.maximum(r.cpu().numpy(), 1e-7)))
            albedo.append(a.cpu().numpy())
        return {"metallic": np.concatenate(metallic, 0),
                "roughness": np.concatenate(roughness, 0),
                "albedo": np.concatenate(albedo, 0)}

    @torch.no_grad()
    def predict_materials_at(self, points: np.ndarray, params=None) -> np.ndarray:
        """[N,3] pts -> [N,5] (albedo3, metallic, roughness) for texture baking."""
        params = self.params if params is None else params
        pts = torch.as_tensor(np.asarray(points, np.float32), device=self.device)
        m, r, a = predict_materials_mc(params, pts)
        return torch.cat([a, m, r], dim=1).cpu().numpy()

    @torch.no_grad()
    def env_light(self, h: int, w: int, params=None, gamma: bool = True) -> np.ndarray:
        params = self.params if params is None else params
        return env_light_image(params, self.mcfg, h, w, gamma, device=self.device).cpu().numpy()

    def num_train_rays_per_step(self) -> int:
        """The global batch: every rank's rows together."""
        return self.cfg["train_ray_num"]
