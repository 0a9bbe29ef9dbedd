"""Ray generation from intrinsics/poses, on the device that holds the images.

Counterpart of nero_tpu/render/rays.py: pixel centres at (x+0.5, y+0.5), w2c
poses [R|t] with camera centre -R^T t, ray dir = normalize(R^T K^-1 [x,y,1]).
The per-step batch is drawn with an explicit `torch.Generator` on the
images' device (the JAX package threads PRNG keys instead); under ray data
parallelism every rank draws the global batch and keeps its rows.
"""
from __future__ import annotations

import torch

from nero_tpu_torch.utils.sphere import near_far_from_sphere


def rays_from_pixels(coords_xy: torch.Tensor, K_inv: torch.Tensor, poses: torch.Tensor):
    """coords_xy [...,2]; K_inv [...,3,3]; poses [...,3,4] -> rays_o, rays_d, near, far."""
    homo = torch.cat([coords_xy, torch.ones_like(coords_xy[..., :1])], dim=-1)
    d_cam = torch.einsum("...ij,...j->...i", K_inv, homo)
    R = poses[..., :3, :3]
    t = poses[..., :3, 3]
    rays_d = torch.einsum("...ji,...j->...i", R, d_cam)
    rays_d = rays_d / torch.clamp(torch.linalg.norm(rays_d, dim=-1, keepdim=True), min=1e-12)
    rays_o = -torch.einsum("...ji,...j->...i", R, t)
    rays_o = torch.broadcast_to(rays_o, rays_d.shape)
    near, far = near_far_from_sphere(rays_o, rays_d)
    return rays_o, rays_d, near, far


def sample_ray_batch(gen: torch.Generator, imgs_u8: torch.Tensor, K_inv: torch.Tensor,
                     poses: torch.Tensor, batch: int,
                     human_poses: torch.Tensor | None = None, rows: slice | None = None) -> dict:
    """Uniform random rays across all images. imgs_u8 [N,H,W,3] uint8. With
    `human_poses` [N,3,4] (one per image) each ray also gets its image's.
    With `rows`, the rays of those rows of the `batch` drawn."""
    n, h, w, _ = imgs_u8.shape
    idx = torch.randint(0, n * h * w, (batch,), generator=gen, device=imgs_u8.device)
    if rows is not None:
        idx = idx[rows]
    img_i = idx // (h * w)
    pix = idx % (h * w)
    py, px = pix // w, pix % w
    coords = torch.stack([px.float() + 0.5, py.float() + 0.5], dim=-1)
    rgb = imgs_u8[img_i, py, px].float() / 255.0
    rays_o, rays_d, near, far = rays_from_pixels(coords, K_inv[img_i], poses[img_i])
    out = {"rays_o": rays_o, "rays_d": rays_d, "near": near, "far": far, "rgb": rgb}
    if human_poses is not None:
        out["human_poses"] = human_poses[img_i]
    return out


def human_coordinate_poses(poses: torch.Tensor, fixed_camera: bool = False) -> torch.Tensor:
    """Per-camera 'human' frame: z-flattened camera frame used by the human
    light. [N,3,4] -> [N,3,4]. Y = world -z, Z = flattened camera z-axis."""
    R_w2c = poses[..., :3, :3]
    cam_cen = -torch.einsum("...ji,...j->...i", R_w2c, poses[..., :3, 3])
    if not fixed_camera:
        cam_cen = torch.cat([cam_cen[..., :2], torch.zeros_like(cam_cen[..., 2:])], dim=-1)
    n = poses.shape[0]
    Y = torch.tensor([0.0, 0.0, -1.0], dtype=poses.dtype, device=poses.device).expand(n, 3)
    Z = torch.cat([poses[:, 2, :2], torch.zeros_like(poses[:, 2, 2:3])], dim=-1)
    Z = Z / torch.clamp(torch.linalg.norm(Z, dim=-1, keepdim=True), min=1e-12)
    X = torch.linalg.cross(Y, Z)
    R = torch.stack([X, Y, Z], dim=1)
    t = -torch.einsum("nij,nj->ni", R, cam_cen)
    return torch.cat([R, t[:, :, None]], dim=-1)
