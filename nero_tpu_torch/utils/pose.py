"""Host-side pose algebra (numpy) used by the procedural dataset: w2c [3,4].
Copy of the parts of nero_tpu/utils/pose.py the slice needs."""
from __future__ import annotations

import numpy as np


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
