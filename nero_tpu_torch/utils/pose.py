"""Host-side pose algebra (numpy): w2c [3,4] matrices. Copy of the parts of
nero_tpu/utils/pose.py that the procedural dataset and the evaluators need
(look-at poses; inverse, compose, apply; masked depth to points)."""
from __future__ import annotations

import numpy as np


def pose_inverse(pose: np.ndarray) -> np.ndarray:
    """[R|t] -> [R^T | -R^T t]."""
    R = pose[:, :3].T
    t = -R @ pose[:, 3:]
    return np.concatenate([R, t], axis=-1)


def pose_compose(pose0: np.ndarray, pose1: np.ndarray) -> np.ndarray:
    """Apply pose0 then pose1 (x -> R1(R0 x + t0) + t1)."""
    R = pose1[:, :3] @ pose0[:, :3]
    t = pose1[:, :3] @ pose0[:, 3:] + pose1[:, 3:]
    return np.concatenate([R, t], axis=-1)


def pose_apply(pose: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ pose[:, :3].T + pose[:, 3][None, :]


def mask_depth_to_pts(mask: np.ndarray, depth: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Back-project masked depth pixels into camera-space 3D points."""
    ys, xs = np.nonzero(mask)
    d = depth[ys, xs]
    pts = np.stack([xs + 0.5, ys + 0.5, np.ones_like(d)], axis=-1) * d[:, None]
    return pts @ np.linalg.inv(K).T


def look_at_rotation(eye: np.ndarray, target: np.ndarray,
                     world_up=np.asarray([0.0, 0.0, 1.0])) -> np.ndarray:
    """OpenCV-convention w2c rotation (rows = right, down, forward)."""
    forward = target - eye
    forward = forward / np.linalg.norm(forward)
    right = np.cross(forward, world_up)
    nr = np.linalg.norm(right)
    if nr < 1e-6:
        right = np.asarray([1.0, 0.0, 0.0])
    else:
        right = right / nr
    down = np.cross(forward, right)
    return np.stack([right, down, forward], axis=0)


def look_at_pose(eye: np.ndarray, target: np.ndarray,
                 world_up=np.asarray([0.0, 0.0, 1.0])) -> np.ndarray:
    R = look_at_rotation(eye, target, world_up)
    t = -R @ eye[:, None]
    return np.concatenate([R, t], axis=-1).astype(np.float32)
