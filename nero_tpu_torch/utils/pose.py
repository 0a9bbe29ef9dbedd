"""Host-side pose algebra (numpy): w2c [3,4] matrices. The port's own copy
of nero_tpu/utils/pose.py: look-at poses; inverse, compose, apply;
projection; masked depth to points; pose errors and their AUC; the
look-at crop of the COLMAP object databases."""
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


def project_points(pts: np.ndarray, pose: np.ndarray, K: np.ndarray):
    """World points -> pixel coords + depth."""
    cam = pose_apply(pose, pts)
    depth = cam[:, 2:]
    uvw = cam @ K.T
    uv = uvw[:, :2] / np.maximum(uvw[:, 2:], 1e-8)
    return uv, depth[:, 0]


def mask_depth_to_pts(mask: np.ndarray, depth: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Back-project masked depth pixels into camera-space 3D points."""
    ys, xs = np.nonzero(mask)
    d = depth[ys, xs]
    pts = np.stack([xs + 0.5, ys + 0.5, np.ones_like(d)], axis=-1) * d[:, None]
    return pts @ np.linalg.inv(K).T


def rotation_angle_deg(R0: np.ndarray, R1: np.ndarray) -> float:
    """Geodesic angle between two rotations, degrees."""
    cos = (np.trace(R0.T @ R1) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def pose_errors(pose_pr: np.ndarray, pose_gt: np.ndarray):
    """(rotation error deg, camera-centre distance) between two w2c poses."""
    r_err = rotation_angle_deg(pose_pr[:, :3], pose_gt[:, :3])
    c_pr = -pose_pr[:, :3].T @ pose_pr[:, 3]
    c_gt = -pose_gt[:, :3].T @ pose_gt[:, 3]
    return r_err, float(np.linalg.norm(c_pr - c_gt))


def pose_auc(errors, thresholds=(5.0, 10.0, 20.0)):
    """Area-under-curve of the error CDF at the given thresholds (percent)."""
    errors = np.sort(np.asarray(errors, np.float64))
    n = len(errors)
    recall = (np.arange(n) + 1) / n
    errors = np.concatenate([[0.0], errors])
    recall = np.concatenate([[0.0], recall])
    aucs = []
    for t in thresholds:
        last = np.searchsorted(errors, t)
        r = np.concatenate([recall[:last], [recall[min(last, n) - 1] if last > 0 else 0.0]])
        e = np.concatenate([errors[:last], [t]])
        aucs.append(float(np.trapezoid(r, e) / t))
    return aucs


def image_plane_look_at_rotation(point_2d: np.ndarray) -> np.ndarray:
    """Rotation that brings the normalized image point (x, y) onto the optical
    axis: R @ [x, y, 1] ∝ [0, 0, 1]."""
    x, y = float(point_2d[0]), float(point_2d[1])
    a = -np.arctan2(x, 1.0)
    b = np.arctan2(y, 1.0)
    ca, sa = np.cos(a), np.sin(a)
    cb, sb = np.cos(b), np.sin(b)
    Ry = np.asarray([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]])
    Rx = np.asarray([[1, 0, 0], [0, cb, -sb], [0, sb, cb]])
    return Rx @ Ry


def look_at_crop(img: np.ndarray, K: np.ndarray, pose: np.ndarray,
                 position: np.ndarray, angle: float, scale: float,
                 h: int, w: int):
    """Rotate the camera to centre `position`, scale focal, warp the image.

    Returns (img_new, K_new, pose_new, pose_rect, H): the fixed-size
    object-centred crop of the COLMAP object databases."""
    from nero_tpu_torch.utils.image import downsample_gaussian_blur, warp_perspective
    f_raw = (K[0, 0] + K[1, 1]) / 2.0
    centered = np.asarray(position, np.float64) - K[:2, 2]
    f_new = np.sqrt(np.linalg.norm(centered) ** 2 + f_raw ** 2)
    R_new = image_plane_look_at_rotation(centered / f_raw)
    ca, sa = np.cos(angle), np.sin(angle)
    R_z = np.asarray([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]])
    R_new = R_z @ R_new
    f_new = f_new * scale
    K_new = np.asarray([[f_new, 0, w / 2], [0, f_new, h / 2], [0, 0, 1]], np.float32)

    H = K_new @ R_new @ np.linalg.inv(K)
    if scale < 1.0:
        img = downsample_gaussian_blur(img, scale)
    img_new = warp_perspective(img, H, (w, h))

    pose_rect = np.concatenate([R_new, np.zeros([3, 1])], 1).astype(np.float32)
    pose_new = pose_compose(pose, pose_rect)
    return img_new, K_new, pose_new.astype(np.float32), pose_rect, H


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
