"""Stage-I shape model: device-resident images + the train step.

Counterpart of nero_tpu/models/shape.py. The training images live on the
device as uint8; each step samples a ray batch there with the model's
`torch.Generator`, renders it, sums the losses (same names as
nero_tpu/models/shape.py:107-128), back-propagates and takes an Adam step.
Every ray carries the 'human' pose of its camera (render/rays.py::
human_coordinate_poses; `fixed_camera` keeps the camera centre's height),
which the shader's human light reads. With `val_geometry`, the first
validation view also carries a 128^3 mesh of the SDF; `predict_materials`
gives Stage I's per-vertex materials of a mesh.

With a ray group (`group`, parallel/mesh.py::make_data_group) the step is
nero_tpu's step over a data mesh (models/shape.py:100-128 with
constrain_rays): every rank draws the global batch from its generator, which
all ranks hold in the same state, renders its rows with global draws and
global loss reductions, and all-reduces the gradients before the optimizer
step, so every rank holds the same parameters and the same log.
"""
from __future__ import annotations

import numpy as np
import torch

from nero_tpu_torch.core.convert import tree_leaves
from nero_tpu_torch.core.device import resolve_device
from nero_tpu_torch.core.trace import span
from nero_tpu_torch.dataset.database import (BaseDatabase, get_database_split,
                                             parse_database_name)
from nero_tpu_torch.fields.app_shading import predict_materials as shader_materials
from nero_tpu_torch.fields.sdf import sdf_apply, sdf_value
from nero_tpu_torch.geometry.isosurface import extract_geometry
from nero_tpu_torch.geometry.mesh_io import read_ply
from nero_tpu_torch.ops.fg_lut import get_fg_lut
from nero_tpu_torch.parallel.mesh import DataGroup, RayShard, all_reduce_grads, shard_of
from nero_tpu_torch.render.rays import (human_coordinate_poses, rays_from_pixels,
                                        sample_ray_batch)
from nero_tpu_torch.render.shape import (ShapeConfig, compute_rgb_loss, init_shape_params,
                                         render, shape_config_from_dict)
from nero_tpu_torch.train.losses import compute_losses, global_means, total_loss
from nero_tpu_torch.utils.image import downsample_gaussian_blur, resize_bilinear

DEFAULT_SHAPE_CFG = {
    "database_name": "proc/sphere/64",
    "train_ray_num": 512,
    "test_ray_num": 1024,
    "test_downsample_ratio": True,
    "downsample_ratio": 0.25,
    "val_geometry": False,
    "rgb_loss": "charbonier",
    "fixed_camera": False,
    "random_seed": 6033,
    "loss": ["nerf_render", "eikonal", "std", "init_sdf_reg", "occ"],
}


def build_imgs_info(database: BaseDatabase, img_ids) -> dict:
    images = np.stack([database.get_image(i) for i in img_ids], 0)
    Ks = np.stack([database.get_K(i) for i in img_ids], 0).astype(np.float32)
    poses = np.stack([database.get_pose(i) for i in img_ids], 0).astype(np.float32)
    return {"imgs": images, "Ks": Ks, "poses": poses}


def imgs_info_downsample(imgs_info: dict, ratio: float) -> dict:
    """Gaussian-prefiltered downsample of images + intrinsics rescale."""
    imgs = imgs_info["imgs"]
    n, h, w, _ = imgs.shape
    dh, dw = int(ratio * h), int(ratio * w)
    out_imgs, out_Ks = [], []
    for i in range(n):
        img = downsample_gaussian_blur(imgs[i].astype(np.float32) / 255.0, ratio)
        img = resize_bilinear(img, (dh, dw))
        out_imgs.append((np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8))
        out_Ks.append(np.diag([dw / w, dh / h, 1]).astype(np.float32) @ imgs_info["Ks"][i])
    return {"imgs": np.stack(out_imgs), "Ks": np.stack(out_Ks), "poses": imgs_info["poses"]}


class NeROShapeModel:
    def __init__(self, cfg: dict, training: bool = True, device=None,
                 group: DataGroup | None = None):
        self.cfg = {**DEFAULT_SHAPE_CFG, **cfg}
        self.device = resolve_device(device)
        self.group = group
        # sdf_grad_mode and bf16_hidden as they resolve on this device
        self.scfg: ShapeConfig = shape_config_from_dict(self.cfg).resolved(self.device)
        self.fg_lut = torch.as_tensor(get_fg_lut(), device=self.device)
        seed = self.cfg["random_seed"]
        self.params = init_shape_params(torch.Generator().manual_seed(seed), self.scfg,
                                        device=self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.database = None
        if training:
            self._init_dataset()

    def _init_dataset(self):
        self.database = parse_database_name(self.cfg["database_name"])
        self.train_ids, self.test_ids = get_database_split(self.database)
        info = build_imgs_info(self.database, self.train_ids)
        dev = self.device
        poses = torch.as_tensor(info["poses"], device=dev)
        self.train_data = {
            "imgs_u8": torch.as_tensor(info["imgs"], device=dev),
            "K_inv": torch.linalg.inv(torch.as_tensor(info["Ks"], device=dev)),
            "poses": poses,
            "human_poses": human_coordinate_poses(poses, self.cfg["fixed_camera"]),
        }
        self.test_imgs_info = build_imgs_info(self.database, self.test_ids)

    def parameters(self) -> list:
        return tree_leaves(self.params)

    # ------------------------------------------------------------ train step
    def loss_fn(self, params, batch: dict, step: int, gen: torch.Generator | None,
                shard: RayShard | None = None):
        """(total loss, log dict) of one rendered batch; with `shard`, of
        this rank's rows, the total over the global batch."""
        cfg = self.cfg
        out = render(params, self.scfg, self.fg_lut, batch["rays_o"], batch["rays_d"],
                     batch["near"], batch["far"], step, gen=gen, is_train=True,
                     human_poses=batch.get("human_poses"), shard=shard)
        with span("nero.step.losses"):
            out["loss_rgb"] = compute_rgb_loss(out["ray_rgb"], batch["rgb"], cfg["rgb_loss"])
            log = compute_losses(cfg["loss"], out, None, step, cfg, shard)
            return total_loss(log, shard), log

    def train_step(self, optimizer: torch.optim.Optimizer, step: int) -> dict:
        """Sample a batch, render, back-propagate, update. Returns the log
        (device tensors; reading them synchronises)."""
        with span("nero.step"):
            d = self.train_data
            shard = shard_of(self.group, self.cfg["train_ray_num"])
            with span("nero.step.sample_rays"):
                batch = sample_ray_batch(self.gen, d["imgs_u8"], d["K_inv"], d["poses"],
                                         self.cfg["train_ray_num"], d["human_poses"],
                                         rows=None if shard is None else shard.rows)
            with span("nero.step.forward"):
                loss, log = self.loss_fn(self.params, batch, step, self.gen, shard)
            with span("nero.step.optimizer"):
                optimizer.zero_grad(set_to_none=True)
            with span("nero.step.backward"):
                loss.backward()
                if self.group is not None:
                    all_reduce_grads(self.parameters(), self.group)
            with span("nero.step.optimizer"):
                optimizer.step()
            with span("nero.step.log"):
                log = global_means(log, shard)
                log["loss_total"] = loss.detach()
            return log

    # ------------------------------------------------------------- test step
    @torch.no_grad()
    def _render_rays_chunked(self, params, rays: dict, step: int) -> dict:
        trn = self.cfg["test_ray_num"]
        rn = rays["rays_o"].shape[0]
        outs = []
        for ri in range(0, rn, trn):
            cur = {k: v[ri:ri + trn] for k, v in rays.items()}
            out = render(params, self.scfg, self.fg_lut, cur["rays_o"], cur["rays_d"],
                         cur["near"], cur["far"], step, gen=None, is_train=False,
                         perturb_overwrite=0.0, human_poses=cur["human_poses"])
            outs.append({k: v.cpu().numpy() for k, v in out.items()})
        return {k: np.concatenate([np.atleast_1d(o[k]) for o in outs], 0) for k in outs[0]}

    def _image_rays(self, K: np.ndarray, pose: np.ndarray, h: int, w: int) -> dict:
        xs, ys = np.meshgrid(np.arange(w, dtype=np.float32) + 0.5,
                             np.arange(h, dtype=np.float32) + 0.5)
        coords = torch.as_tensor(np.stack([xs, ys], -1).reshape(-1, 2), device=self.device)
        K_inv = torch.as_tensor(np.linalg.inv(K).astype(np.float32), device=self.device)
        pose_t = torch.as_tensor(pose.astype(np.float32), device=self.device)
        rays_o, rays_d, near, far = rays_from_pixels(coords, K_inv[None], pose_t[None])
        human = human_coordinate_poses(pose_t[None], self.cfg["fixed_camera"])
        return {"rays_o": rays_o.contiguous(), "rays_d": rays_d, "near": near, "far": far,
                "human_poses": human.expand(coords.shape[0], 3, 4)}

    def test_step(self, params, index: int, step: int) -> dict:
        """Render one downsampled validation view + its ground truth."""
        info = {k: v[index:index + 1] for k, v in self.test_imgs_info.items()}
        gt_depth, gt_mask = self.database.get_depth(self.test_ids[index])
        if self.cfg["test_downsample_ratio"]:
            ratio = self.cfg["downsample_ratio"]
            info = imgs_info_downsample(info, ratio)
            h, w = gt_depth.shape
            dh, dw = int(ratio * h), int(ratio * w)
            idx_y = (np.arange(dh) / ratio).astype(np.int64).clip(0, h - 1)
            idx_x = (np.arange(dw) / ratio).astype(np.int64).clip(0, w - 1)
            gt_depth = gt_depth[idx_y][:, idx_x]
            gt_mask = gt_mask[idx_y][:, idx_x]
        h, w = info["imgs"].shape[1:3]
        rays = self._image_rays(info["Ks"][0], info["poses"][0], h, w)
        outputs = self._render_rays_chunked(params, rays, step)
        gt_rgb = info["imgs"][0].astype(np.float32) / 255.0
        outputs["gt_rgb"] = gt_rgb
        outputs["loss_rgb"] = compute_rgb_loss(
            torch.as_tensor(outputs["ray_rgb"]), torch.as_tensor(gt_rgb.reshape(-1, 3)),
            self.cfg["rgb_loss"]).numpy()
        for k, v in outputs.items():
            if isinstance(v, np.ndarray) and v.ndim == 2 and v.shape[0] == h * w:
                outputs[k] = v.reshape(h, w, -1)
        outputs["gt_depth"] = gt_depth[..., None]
        outputs["gt_mask"] = gt_mask[..., None].astype(np.int32)
        if self.cfg["val_geometry"] and index == 0:
            # low-resolution geometry snapshot of the validation
            sdf_cfg = self.scfg.sdf_cfg
            outputs["vertices"], outputs["triangles"] = extract_geometry(
                [-1, -1, -1], [1, 1, 1], 128, 0.0,
                lambda p: sdf_value(params["sdf"], p, sdf_cfg), device=self.device)
        return outputs

    def nvs(self, params, pose: np.ndarray, K: np.ndarray, h: int, w: int,
            step: int = 300000) -> np.ndarray:
        rays = self._image_rays(K.astype(np.float32), pose.astype(np.float32), h, w)
        return self._render_rays_chunked(params, rays, step)["ray_rgb"].reshape(h, w, 3)

    @torch.no_grad()
    def predict_materials(self, params=None, mesh_path: str | None = None,
                          vertices: np.ndarray | None = None, batch_size: int = 8192) -> dict:
        """Stage-I per-vertex materials of a mesh (`mesh_path` or `vertices`):
        the SDF's features at each vertex through the shader's metallic,
        roughness and albedo heads, `batch_size` vertices at a time."""
        params = self.params if params is None else params
        if vertices is None:
            vertices = read_ply(mesh_path)["vertices"]
        sdf_cfg = self.scfg.sdf_cfg
        out = {"metallic": [], "roughness": [], "albedo": []}
        for vi in range(0, len(vertices), batch_size):
            x = torch.as_tensor(np.asarray(vertices[vi:vi + batch_size], np.float32),
                                device=self.device)
            feats = sdf_apply(params["sdf"], x, sdf_cfg)[..., 1:]
            for k, v in zip(out, shader_materials(params["shader"], x, feats)):
                out[k].append(v.cpu().numpy())
        return {k: np.concatenate(v, 0) for k, v in out.items()}

    def num_train_rays_per_step(self) -> int:
        """The global batch: every rank's rows together."""
        return self.cfg["train_ray_num"]
