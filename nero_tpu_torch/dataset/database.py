"""Scene databases for the port: the procedural `proc/` family.

Counterpart of the parts of nero_tpu/dataset/database.py that Stage-I
training and evaluation on a procedural scene need: `ProceduralDatabase`,
`parse_database_name` (other families raise until a later slice ports them),
the seed-6033 validation split of `get_database_split`, and the fused
depth cloud that the Chamfer evaluation compares a mesh with
(`get_database_eval_points`, `voxel_downsample`).
"""
from __future__ import annotations

import abc
import random

import numpy as np

from nero_tpu_torch.dataset.synthetic import make_cameras, render_view
from nero_tpu_torch.utils.pose import mask_depth_to_pts, pose_apply, pose_inverse


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
    family = database_name.split("/")[0]
    if family != "proc":
        raise NotImplementedError(
            f"database family {family!r} is not ported yet; nero_tpu_torch reads proc/ scenes")
    return ProceduralDatabase(database_name)


def get_database_split(database: BaseDatabase, split_type: str = "validation"):
    """validation = seed-6033 shuffle with one held-out image."""
    if split_type != "validation":
        raise NotImplementedError(split_type)
    rng = random.Random(6033)
    img_ids = list(database.get_img_ids())
    rng.shuffle(img_ids)
    return img_ids[1:], img_ids[:1]


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
    """Fused depth point cloud of every view of a procedural scene (full
    coverage of the analytic surface), voxel-downsampled: the ground truth of
    the Chamfer evaluation."""
    if not isinstance(database, ProceduralDatabase):
        raise NotImplementedError(
            f"evaluation points of {type(database).__name__}: only proc/ scenes are ported; "
            "the GlossySynthetic reader and its eval_pts.npy wait for ROADMAP queue A, item 4")
    pts = []
    for img_id in database.get_img_ids():
        depth, mask = database.get_depth(img_id)
        pts_cam = mask_depth_to_pts(mask, depth, database.get_K(img_id))
        pts.append(pose_apply(pose_inverse(database.get_pose(img_id)), pts_cam))
    return voxel_downsample(np.concatenate(pts, 0).astype(np.float32), voxel_size)
