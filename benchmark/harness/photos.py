"""The benchmark's photos: a scene of `benchmark/scenes/<name>.json`
(analytic objects inside the unit sphere, lights, cameras on a sphere around
them) rendered by the benchmark itself and written once per checkout in
NeRO's GlossySynthetic layout (`<k>.png`, `<k>-camera.pkl` holding the w2c
pose and the intrinsics), where the program's `syn/<name>` database reads
them as it reads `syn/bell`. The reference reads the same files.

Nothing here imports the program: the program's data root is handed in.
"""
from __future__ import annotations

import json
import math
import os
import pickle
import random
import shutil

import numpy as np
import torch

from benchmark.harness.catalog import HERE

SPLIT_SEED = 6033      # NeRO's validation split: a seeded shuffle, one view held out


def spec(name: str, root: str = HERE) -> dict:
    with open(os.path.join(root, "scenes", f"{name}.json")) as f:
        return json.load(f)


def scene_dir(data_root: str, name: str) -> str:
    return os.path.join(data_root, "GlossySynthetic", name)


def cameras(s: dict):
    """(w2c poses [V, 3, 4], intrinsics [V, 3, 3]) of a scene's views:
    Fibonacci-spaced on the sphere of radius `distance` between two
    elevations, each looking at the origin with +z up (OpenCV axes)."""
    v = s["views"]
    lo, hi = (math.sin(math.radians(e)) for e in s["elevation_deg"])
    golden = math.pi * (3.0 - math.sqrt(5.0))
    poses, Ks = [], []
    K = np.array([[s["focal"], 0.0, s["width"] / 2], [0.0, s["focal"], s["height"] / 2],
                  [0.0, 0.0, 1.0]], np.float32)
    for k in range(v):
        z = lo + (hi - lo) * (k + 0.5) / v
        az = k * golden
        eye = s["distance"] * np.array([math.sqrt(1 - z * z) * math.cos(az),
                                        math.sqrt(1 - z * z) * math.sin(az), z])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd])
        poses.append(np.concatenate([R, (-R @ eye)[:, None]], 1).astype(np.float32))
        Ks.append(K.copy())
    return np.stack(poses), np.stack(Ks)


def _hit(o, d, obj):
    """Distance along each ray to an axis-aligned ellipsoid (inf where it
    misses) and the surface normal there."""
    c = torch.tensor(obj["center"], dtype=o.dtype, device=o.device)
    r = torch.tensor(obj["radii"], dtype=o.dtype, device=o.device)
    oo, dd = (o - c) / r, d / r
    a = (dd * dd).sum(-1)
    b = (oo * dd).sum(-1)
    disc = b * b - a * ((oo * oo).sum(-1) - 1.0)
    t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / a
    t = torch.where((disc > 0) & (t > 0), t, torch.full_like(t, math.inf))
    n = (o + d * t[:, None] - c) / (r * r)
    return t, n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)


def render_view(s: dict, pose: np.ndarray, K: np.ndarray, device) -> np.ndarray:
    """One photo (uint8 [H, W, 3]): the nearest object shaded by an ambient
    term, directional lights (Lambert and Blinn-Phong) and a light at the
    camera (the photographer's, `headlight`), over a sky-to-ground gradient."""
    h, w = s["height"], s["width"]
    f32 = dict(dtype=torch.float32, device=device)
    ys, xs = torch.meshgrid(torch.arange(h, **f32) + 0.5, torch.arange(w, **f32) + 0.5,
                            indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)
    R, t = torch.tensor(pose[:, :3], **f32), torch.tensor(pose[:, 3], **f32)
    d = pix @ torch.linalg.inv(torch.tensor(K, **f32)).T @ R
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = (-R.T @ t).expand_as(d)
    sky, ground = torch.tensor(s["sky"], **f32), torch.tensor(s["ground"], **f32)
    rgb = ground + (sky - ground) * (0.5 + 0.5 * d[:, 2:3])
    best = torch.full((d.shape[0],), math.inf, **f32)
    for obj in s["objects"]:
        tt, n = _hit(o, d, obj)
        near = tt < best
        best = torch.where(near, tt, best)
        view = -d
        albedo = torch.tensor(obj["albedo"], **f32)
        col = albedo * s["ambient"]
        for light in s["lights"]:
            ld = torch.tensor(light["dir"], **f32)
            ld = ld / torch.linalg.norm(ld)
            half = (ld + view) / torch.linalg.norm(ld + view, dim=-1, keepdim=True)
            col = col + light["strength"] * (
                albedo * torch.clamp((n * ld).sum(-1, keepdim=True), min=0.0)
                + obj["specular"] * torch.clamp((n * half).sum(-1, keepdim=True), min=0.0)
                ** obj["shininess"])
        facing = torch.clamp((n * view).sum(-1, keepdim=True), min=0.0)
        col = col + s["headlight"] * (albedo * facing + obj["specular"]
                                      * facing ** obj["shininess"])
        rgb = torch.where(near[:, None], col, rgb)
    rgb = torch.clamp(rgb, 0.0, 1.0) ** (1.0 / 2.2)
    return (rgb * 255.0 + 0.5).to(torch.uint8).reshape(h, w, 3).cpu().numpy()


def ensure(name: str, data_root: str, device, root: str = HERE) -> str:
    """The scene's directory under `data_root`, rendered and written there
    first if it is not there yet (into a side directory, renamed when whole,
    so a run cut short leaves nothing half written)."""
    from PIL import Image

    out = scene_dir(data_root, name)
    if os.path.isdir(out):
        return out
    s = spec(name, root)
    part = out + ".partial"
    shutil.rmtree(part, ignore_errors=True)
    os.makedirs(part)
    poses, Ks = cameras(s)
    with torch.no_grad():
        for k, (pose, K) in enumerate(zip(poses, Ks)):
            Image.fromarray(render_view(s, pose, K, device)).save(
                os.path.join(part, f"{k}.png"), compress_level=1)
            with open(os.path.join(part, f"{k}-camera.pkl"), "wb") as f:
                pickle.dump([pose, K], f)
    os.replace(part, out)
    return out


def train_ids(views: int) -> list:
    """The training views in the program's order: NeRO's validation split
    (ids shuffled by a seeded `random.Random`, the first held out)."""
    ids = [str(k) for k in range(views)]
    random.Random(SPLIT_SEED).shuffle(ids)
    return ids[1:]


def load(name: str, data_root: str) -> dict:
    """The training photos (uint8 [N, H, W, 3]), intrinsics and w2c poses,
    read back from the files the program reads."""
    from PIL import Image

    d = scene_dir(data_root, name)
    views = len([f for f in os.listdir(d) if f.endswith("-camera.pkl")])
    imgs, Ks, poses = [], [], []
    for k in train_ids(views):
        with Image.open(os.path.join(d, f"{k}.png")) as im:
            imgs.append(np.asarray(im.convert("RGB")))
        with open(os.path.join(d, f"{k}-camera.pkl"), "rb") as f:
            pose, K = pickle.load(f)
        poses.append(np.asarray(pose, np.float32))
        Ks.append(np.asarray(K, np.float32))
    return {"imgs": np.stack(imgs), "Ks": np.stack(Ks), "poses": np.stack(poses)}
