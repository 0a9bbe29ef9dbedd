"""Scene databases: images, intrinsics, w2c poses, depth. The port's own copy
of nero_tpu/dataset/database.py.

Five families, by the first part of the name (`parse_database_name`):
  * `syn/<object>`: GlossySynthetic, <root>/<k>.png + <k>-camera.pkl (pose,
    K) + 16-bit depth PNGs scaled to [0, 15];
  * `real/<object>/<max_len>` and `custom/<object>/<max_len>`: a COLMAP
    sparse model normalised so that the object's point cloud fits the unit
    sphere with `up` as +z, served as object-centred square crops of side
    <max_len> or as whole images resized so their longest side is N
    (`raw_<N>`);
  * `nerf_synthetic/<scene>/<bg>_<res>`: Blender NeRF-synthetic scenes;
  * `proc/<kind>/<res>[_<views>]`: the procedural scenes, rendered on the fly.
Files live under DATA_ROOT, set by NERO_TPU_DATA_ROOT as in nero_tpu, so one
data layout serves both packages. The COLMAP families cache their parse in
`<root>/cache.pkl` and their crops in `<root>/images_<n>/` with
`meta_info.pkl`: plain lists and dicts of numpy arrays, which each package
reads from the other. Splits: `validation` (seed-6033 shuffle, one held-out
image) and `test` (the pickled GlossySynthetic split).
"""
from __future__ import annotations

import abc
import glob
import json
import os
import random
from pathlib import Path

import numpy as np

from nero_tpu_torch.core.paths import repo_path
from nero_tpu_torch.dataset.colmap_model import camera_K, read_model
from nero_tpu_torch.dataset.synthetic import make_cameras, render_view
from nero_tpu_torch.geometry.mesh_io import read_ply
from nero_tpu_torch.utils.image import imread, imsave, resize_img
from nero_tpu_torch.utils.io import read_pickle, save_pickle
from nero_tpu_torch.utils.pose import (look_at_crop, mask_depth_to_pts, pose_apply,
                                       pose_inverse, project_points)

DATA_ROOT = os.environ.get("NERO_TPU_DATA_ROOT", "data")


class BaseDatabase(abc.ABC):
    def __init__(self, database_name: str):
        self.database_name = database_name

    @abc.abstractmethod
    def get_image(self, img_id) -> np.ndarray: ...

    @abc.abstractmethod
    def get_K(self, img_id) -> np.ndarray: ...

    @abc.abstractmethod
    def get_pose(self, img_id) -> np.ndarray: ...

    @abc.abstractmethod
    def get_img_ids(self): ...

    @abc.abstractmethod
    def get_depth(self, img_id): ...


class GlossySyntheticDatabase(BaseDatabase):
    """Blender-rendered scenes: <root>/<k>.png + <k>-camera.pkl (pose, K) +
    16-bit depth PNGs scaled to [0, 15]."""

    def __init__(self, database_name: str):
        super().__init__(database_name)
        _, model_name = database_name.split("/")
        self.root = f"{DATA_ROOT}/GlossySynthetic/{model_name}"
        self.img_num = len(glob.glob(f"{self.root}/*.pkl"))
        self.img_ids = [str(k) for k in range(self.img_num)]
        self.cams = [read_pickle(f"{self.root}/{k}-camera.pkl") for k in range(self.img_num)]
        self.scale_factor = 1.0

    def get_image(self, img_id):
        return imread(f"{self.root}/{img_id}.png")[..., :3]

    def get_K(self, img_id):
        return self.cams[int(img_id)][1].astype(np.float32)

    def get_pose(self, img_id):
        pose = self.cams[int(img_id)][0].astype(np.float32).copy()
        pose[:, 3:] *= self.scale_factor
        return pose

    def get_img_ids(self):
        return self.img_ids

    def get_depth(self, img_id):
        depth = imread(f"{self.root}/{img_id}-depth.png")
        depth = depth.astype(np.float32) / 65535 * 15
        return depth, depth < 14.5


def _compute_normalization_rotation(vert: np.ndarray, forward: np.ndarray) -> np.ndarray:
    y = np.cross(vert, forward)
    x = np.cross(y, vert)
    vert = vert / np.linalg.norm(vert)
    x = x / np.linalg.norm(x)
    y = y / np.linalg.norm(y)
    return np.stack([x, y, vert], 0)


class _ColmapObjectDatabase(BaseDatabase):
    """Shared machinery for GlossyReal / Custom: parse the COLMAP sparse model,
    normalise world coords so the object point cloud fits the unit sphere with
    `up` as +z, then serve cropped or resized images with their intrinsics."""

    def __init__(self, database_name: str, root: str, up: np.ndarray, forward: np.ndarray):
        super().__init__(database_name)
        _, self.object_name, self.max_len = database_name.split("/")
        self.root = root
        self._parse_colmap()
        self._normalize(up, forward)
        if self.max_len.startswith("raw"):
            self._resize_raw()
        else:
            self.max_len = int(self.max_len)
            self._crop()

    def _parse_colmap(self):
        cache = f"{self.root}/cache.pkl"
        if Path(cache).exists():
            self.poses, self.Ks, self.image_names, self.img_ids = read_pickle(cache)
            return
        cameras, images, _ = read_model(f"{self.root}/colmap/sparse/0")
        self.poses, self.Ks, self.image_names, self.img_ids = {}, {}, {}, []
        for img_id, image in images.items():
            self.img_ids.append(img_id)
            self.image_names[img_id] = image.name
            R = image.rotation()
            pose = np.concatenate([R, image.tvec[:, None]], 1).astype(np.float32)
            self.poses[img_id] = pose
            self.Ks[img_id] = camera_K(cameras[image.camera_id])
        save_pickle([self.poses, self.Ks, self.image_names, self.img_ids], cache)

    def _normalize(self, up: np.ndarray, forward: np.ndarray):
        ref_points = read_ply(f"{self.root}/object_point_cloud.ply")["vertices"].astype(
            np.float64)
        max_pt, min_pt = np.max(ref_points, 0), np.min(ref_points, 0)
        center = (max_pt + min_pt) * 0.5
        offset = -center
        scale = 1.0 / np.max(np.linalg.norm(ref_points - center[None, :], 2, 1))
        up = up / np.linalg.norm(up)
        forward = forward / np.linalg.norm(forward)
        R_rec = _compute_normalization_rotation(up, forward)
        self.ref_points = scale * (ref_points + offset) @ R_rec.T
        self.scale_rect, self.offset_rect, self.R_rect = scale, offset, R_rec
        # world' = R_rec (scale (world + offset)); cameras transform accordingly
        for img_id, pose in self.poses.items():
            R, t = pose[:, :3], pose[:, 3]
            R_new = R @ R_rec.T
            t_new = (t - R @ offset) * scale
            self.poses[img_id] = np.concatenate([R_new, t_new[:, None]], -1).astype(np.float32)

    def _crop(self):
        """Fixed-size object-centred crops with rotated and rescaled cameras,
        written once to images_<n>/ with their poses and intrinsics in
        meta_info.pkl."""
        size = self.max_len
        meta = Path(f"{self.root}/images_{size}/meta_info.pkl")
        if meta.exists():
            self.poses, self.Ks = read_pickle(str(meta))
            return
        meta.parent.mkdir(exist_ok=True, parents=True)
        poses_new, Ks_new = {}, {}
        for img_id in self.img_ids:
            pose, K = self.poses[img_id], self.Ks[img_id]
            img = imread(f"{self.root}/images/{self.image_names[img_id]}")
            h, w = img.shape[:2]
            pts2d, _ = project_points(self.ref_points, pose, K)
            pts2d[:, 0] = np.clip(pts2d[:, 0], 0, w - 1)
            pts2d[:, 1] = np.clip(pts2d[:, 1], 0, h - 1)
            pt_min, pt_max = np.min(pts2d, 0), np.max(pts2d, 0)
            region = min(float(np.max(pt_max - pt_min)), h - 3, w - 3)

            def centre(axis_min, axis_max, axis_size, bound):
                if region <= axis_size:
                    return (axis_min + axis_max) / 2
                b0 = max(region / 2, axis_max - region / 2)
                b1 = min(axis_min + region / 2, bound - 2 - region / 2)
                return (b0 + b1) / 2

            cx = centre(pt_min[0], pt_max[0], pt_max[0] - pt_min[0], w)
            cy = centre(pt_min[1], pt_max[1], pt_max[1] - pt_min[1], h)
            scale = size / region
            img1, K1, pose1, _, _ = look_at_crop(
                img, K, pose, np.asarray([cx, cy], np.float32), 0, scale, size, size)
            imsave(f"{self.root}/images_{size}/{self.image_names[img_id]}", img1)
            poses_new[img_id] = pose1
            Ks_new[img_id] = K1
        save_pickle([poses_new, Ks_new], str(meta))
        self.poses, self.Ks = poses_new, Ks_new

    def _resize_raw(self):
        first = imread(f"{self.root}/images/{self.image_names[self.img_ids[0]]}")
        h, w = first.shape[:2]
        max_len = int(self.max_len.split("_")[1])
        ratio = float(max_len) / max(h, w)
        th, tw = int(ratio * h), int(ratio * w)
        rh, rw = th / h, tw / w
        out_dir = Path(f"{self.root}/images_{self.max_len}")
        out_dir.mkdir(exist_ok=True, parents=True)
        for img_id in self.img_ids:
            dst = out_dir / self.image_names[img_id]
            if not dst.exists():
                img = imread(f"{self.root}/images/{self.image_names[img_id]}")
                imsave(str(dst), resize_img(img, ratio))
            self.Ks[img_id] = (np.diag([rw, rh, 1.0]) @ self.Ks[img_id]).astype(np.float32)

    def get_image(self, img_id):
        return imread(f"{self.root}/images_{self.max_len}/{self.image_names[img_id]}")[..., :3]

    def get_K(self, img_id):
        return self.Ks[img_id].copy()

    def get_pose(self, img_id):
        return self.poses[img_id].copy()

    def get_img_ids(self):
        return self.img_ids

    def get_depth(self, img_id):
        img = self.get_image(img_id)
        h, w = img.shape[:2]
        return np.ones([h, w], np.float32), np.ones([h, w], bool)


class GlossyRealDatabase(_ColmapObjectDatabase):
    meta_info = {
        "bear": {"forward": np.asarray([0.539944, -0.342791, 0.341446], np.float32),
                 "up": np.asarray((0.0512875, -0.645326, -0.762183), np.float32)},
        "coral": {"forward": np.asarray([0.004226, -0.235523, 0.267582], np.float32),
                  "up": np.asarray((0.0477973, -0.748313, -0.661622), np.float32)},
        "maneki": {"forward": np.asarray([-2.336584, -0.406351, 0.482029], np.float32),
                   "up": np.asarray((-0.0117387, -0.738751, -0.673876), np.float32)},
        "bunny": {"forward": np.asarray([0.437076, -1.672467, 1.436961], np.float32),
                  "up": np.asarray((-0.0693234, -0.644819, -.761185), np.float32)},
        "vase": {"forward": np.asarray([-0.911907, -0.132777, 0.180063], np.float32),
                 "up": np.asarray((-0.01911, -0.738918, -0.673524), np.float32)},
    }

    def __init__(self, database_name: str):
        _, object_name, _ = database_name.split("/")
        meta = self.meta_info[object_name]
        super().__init__(database_name, f"{DATA_ROOT}/GlossyReal/{object_name}",
                         meta["up"].astype(np.float64), meta["forward"].astype(np.float64))


class CustomDatabase(_ColmapObjectDatabase):
    """A user's capture: <DATA_ROOT>/custom/<object>/ with images/,
    colmap/sparse/0/, object_point_cloud.ply and meta_info.txt (rows: up,
    forward)."""

    def __init__(self, database_name: str):
        _, object_name, _ = database_name.split("/")
        root = f"{DATA_ROOT}/custom/{object_name}"
        directions = np.loadtxt(f"{root}/meta_info.txt")
        super().__init__(database_name, root, directions[0], directions[1])


class NeRFSyntheticDatabase(BaseDatabase):
    """Blender NeRF-Synthetic / Shiny-Blender scenes,
    'nerf_synthetic/<scene>/<bg>_<res>' (e.g. lego/black_800). Reads
    transforms_{train,test,val}.json; OpenGL c2w matrices become OpenCV w2c;
    RGBA is composited onto the requested background colour."""

    def __init__(self, database_name: str):
        super().__init__(database_name)
        _, scene, spec = database_name.split("/")
        bg, res = spec.split("_")
        self.res = int(res)
        self.bg = {"black": 0.0, "white": 1.0}[bg]
        self.root = f"{DATA_ROOT}/nerf_synthetic/{scene}"
        self.frames, self.img_ids = {}, []
        cam_angle_x = None
        for split in ("train", "test", "val"):
            path = f"{self.root}/transforms_{split}.json"
            if not os.path.exists(path):
                continue
            with open(path) as f:
                meta = json.load(f)
            cam_angle_x = meta["camera_angle_x"]
            for i, frame in enumerate(meta["frames"]):
                img_id = f"{split}-{i}"
                self.img_ids.append(img_id)
                self.frames[img_id] = frame
        assert cam_angle_x is not None, f"no transforms_*.json under {self.root}"
        focal = 0.5 * self.res / np.tan(0.5 * cam_angle_x)
        self.K = np.asarray([[focal, 0, self.res / 2],
                             [0, focal, self.res / 2], [0, 0, 1]], np.float32)

    def get_image(self, img_id):
        frame = self.frames[img_id]
        img = imread(f"{self.root}/{frame['file_path']}.png")
        if img.shape[0] != self.res:
            img = resize_img(img, self.res / img.shape[0])
        if img.shape[-1] == 4:
            rgb = img[..., :3].astype(np.float32) / 255.0
            alpha = img[..., 3:].astype(np.float32) / 255.0
            img = rgb * alpha + self.bg * (1 - alpha)
            img = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
        return img[..., :3]

    def get_K(self, img_id):
        return self.K.copy()

    def get_pose(self, img_id):
        c2w = np.asarray(self.frames[img_id]["transform_matrix"], np.float64)
        # OpenGL camera (x right, y up, z backward) -> OpenCV (y down, z forward)
        c2w = c2w[:3] @ np.diag([1.0, -1.0, -1.0, 1.0])
        R = c2w[:, :3].T
        t = -R @ c2w[:, 3]
        return np.concatenate([R, t[:, None]], -1).astype(np.float32)

    def get_img_ids(self):
        return self.img_ids

    def get_depth(self, img_id):
        img = self.get_image(img_id)
        h, w = img.shape[:2]
        return np.ones([h, w], np.float32), np.ones([h, w], bool)


class ProceduralDatabase(BaseDatabase):
    """Analytic scene rendered on the fly: 'proc/<kind>/<res>[_<views>]'."""

    def __init__(self, database_name: str):
        super().__init__(database_name)
        parts = database_name.split("/")
        self.kind = parts[1] if len(parts) > 1 else "sphere"
        spec = parts[2] if len(parts) > 2 else "64"
        res, views = spec.split("_") if "_" in spec else (spec, "16")
        self.res, self.n_views = int(res), int(views)
        if self.kind in ("bowl", "capture"):
            el_range, dist = (0.35, 1.25), 2.2
        elif self.kind == "mirror":
            el_range, dist = (0.30, 1.15), 2.0
        else:
            el_range, dist = (0.25, 0.75), 3.0
        self.Ks, self.poses = make_cameras(self.n_views, self.res, self.res,
                                           dist=dist, el_range=el_range)
        self.img_ids = [str(i) for i in range(self.n_views)]
        self._cache = {}

    def _render(self, img_id):
        i = int(img_id)
        if i not in self._cache:
            self._cache[i] = render_view(self.poses[i], self.Ks[i], self.res, self.res,
                                         kind=self.kind)
        return self._cache[i]

    def get_image(self, img_id):
        return self._render(img_id)[0]

    def get_K(self, img_id):
        return self.Ks[int(img_id)].copy()

    def get_pose(self, img_id):
        return self.poses[int(img_id)].copy()

    def get_img_ids(self):
        return self.img_ids

    def get_depth(self, img_id):
        _, depth, mask = self._render(img_id)
        return depth, mask


def parse_database_name(database_name: str) -> BaseDatabase:
    name2database = {
        "syn": GlossySyntheticDatabase,
        "real": GlossyRealDatabase,
        "custom": CustomDatabase,
        "proc": ProceduralDatabase,
        "nerf_synthetic": NeRFSyntheticDatabase,
    }
    database_type = database_name.split("/")[0]
    if database_type not in name2database:
        raise NotImplementedError(f"unknown database family {database_type}")
    return name2database[database_type](database_name)


def get_database_split(database: BaseDatabase, split_type: str = "validation"):
    """(train ids, held-out ids). validation = seed-6033 shuffle with one
    held-out image; test = the pickled GlossySynthetic split of 128 views."""
    if split_type == "validation":
        rng = random.Random(6033)
        img_ids = list(database.get_img_ids())
        rng.shuffle(img_ids)
        return img_ids[1:], img_ids[:1]
    if split_type == "test":
        test_ids, train_ids = read_pickle(repo_path("configs", "synthetic_split_128.pkl"))
        return train_ids, test_ids
    raise NotImplementedError(split_type)


def voxel_downsample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Average points per occupied voxel (open3d.voxel_down_sample equivalent)."""
    if len(points) == 0:
        return points
    keys = np.floor(points / voxel_size).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((counts.shape[0], 3), np.float64)
    np.add.at(sums, inv, points)
    return (sums / counts[:, None]).astype(np.float32)


def get_database_eval_points(database: BaseDatabase, voxel_size: float = 0.01) -> np.ndarray:
    """Fused depth point cloud, voxel-downsampled: the ground truth of the
    Chamfer evaluation. GlossySynthetic fuses its `test` views and caches the
    cloud in <root>/eval_pts.npy; a procedural scene fuses every view (full
    coverage of the analytic surface)."""
    if isinstance(database, GlossySyntheticDatabase):
        fn = f"{database.root}/eval_pts.npy"
        if os.path.exists(fn):
            return np.load(fn)
        _, test_ids = get_database_split(database, "test")
    elif isinstance(database, ProceduralDatabase):
        fn = None
        test_ids = database.get_img_ids()
    else:
        raise NotImplementedError(
            f"evaluation points of {type(database).__name__}: only GlossySynthetic and "
            "procedural scenes have depth maps")
    pts = []
    for img_id in test_ids:
        depth, mask = database.get_depth(img_id)
        pts_cam = mask_depth_to_pts(mask, depth, database.get_K(img_id))
        pts.append(pose_apply(pose_inverse(database.get_pose(img_id)), pts_cam))
    pts = voxel_downsample(np.concatenate(pts, 0).astype(np.float32), voxel_size)
    if fn is not None:
        np.save(fn, pts)
    return pts
