"""Reader and writer of COLMAP sparse reconstructions (binary + text):
the port's own copy of nero_tpu/dataset/colmap_model.py.

The COLMAP sparse model format (cameras/images/points3D) is publicly
documented (colmap.github.io/format.html). The databases read the camera
models SIMPLE_RADIAL / SIMPLE_PINHOLE / PINHOLE and per-image quaternion
poses. A text model's images take two lines each, the second holding the
image's 2-D points; it is empty for an image without any, and is read as
such.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in _CAMERA_MODELS.items()}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class Image:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str

    def rotation(self) -> np.ndarray:
        return qvec2rotmat(self.qvec)


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    """Quaternion (w,x,y,z) -> 3x3 rotation matrix."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> quaternion (w,x,y,z), w >= 0."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path: str) -> dict[int, Camera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = _CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            cams[cam_id] = Camera(cam_id, name, int(w), int(h), params)
    return cams


def read_images_binary(path: str) -> dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            img_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            f.seek(n_pts * 24, os.SEEK_CUR)  # skip 2D points (x,y,point3d_id)
            images[img_id] = Image(img_id, qvec, tvec, cam_id, name.decode("utf-8"))
    return images


def read_points3d_binary(path: str) -> np.ndarray:
    """Returns [N,3] xyz (colors/track data skipped)."""
    pts = []
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            _read(f, "<Q")  # point id
            xyz = _read(f, "<3d")
            f.seek(3 + 8, os.SEEK_CUR)  # rgb + error
            (track_len,) = _read(f, "<Q")
            f.seek(track_len * 8, os.SEEK_CUR)
            pts.append(xyz)
    return np.asarray(pts, np.float64)


def read_cameras_text(path: str) -> dict[int, Camera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cams[int(parts[0])] = Camera(int(parts[0]), parts[1], int(parts[2]),
                                         int(parts[3]), np.array([float(p) for p in parts[4:]]))
    return cams


def read_images_text(path: str) -> dict[int, Image]:
    images = {}
    with open(path) as f:
        while True:
            line = f.readline()
            if not line:
                break
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            img_id = int(parts[0])
            qvec = np.array([float(p) for p in parts[1:5]])
            tvec = np.array([float(p) for p in parts[5:8]])
            images[img_id] = Image(img_id, qvec, tvec, int(parts[8]), parts[9])
            f.readline()  # the image's 2-D points, possibly an empty line
    return images


def read_model(sparse_dir: str):
    """Read cameras + images (+points if present) from a COLMAP sparse dir."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cameras = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
        images = read_images_binary(os.path.join(sparse_dir, "images.bin"))
        pts_path = os.path.join(sparse_dir, "points3D.bin")
        points = read_points3d_binary(pts_path) if os.path.exists(pts_path) else None
    else:
        cameras = read_cameras_text(os.path.join(sparse_dir, "cameras.txt"))
        images = read_images_text(os.path.join(sparse_dir, "images.txt"))
        points = None
    return cameras, images, points


def write_cameras_binary(cameras: dict[int, Camera], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            model_id = _MODEL_NAME_TO_ID[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, model_id, cam.width, cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_images_binary(images: dict[int, Image], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for img in images.values():
            f.write(struct.pack("<i", img.id))
            f.write(struct.pack("<4d", *img.qvec))
            f.write(struct.pack("<3d", *img.tvec))
            f.write(struct.pack("<i", img.camera_id))
            f.write(img.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))  # no 2D points


def write_cameras_text(cameras: dict[int, Camera], path: str):
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                f"# Number of cameras: {len(cameras)}\n")
        for cam in cameras.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


def write_images_text(images: dict[int, Image], path: str):
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
                f"# Number of images: {len(images)}\n")
        for img in images.values():
            vals = " ".join(repr(float(v)) for v in (*img.qvec, *img.tvec))
            f.write(f"{img.id} {vals} {img.camera_id} {img.name}\n\n")  # no 2D points


def write_model(cameras: dict, images: dict, sparse_dir: str, ext: str = ".bin"):
    """cameras + images as `.bin` (what COLMAP's mapper writes) or `.txt`."""
    os.makedirs(sparse_dir, exist_ok=True)
    if ext == ".bin":
        write_cameras_binary(cameras, os.path.join(sparse_dir, "cameras.bin"))
        write_images_binary(images, os.path.join(sparse_dir, "images.bin"))
    elif ext == ".txt":
        write_cameras_text(cameras, os.path.join(sparse_dir, "cameras.txt"))
        write_images_text(images, os.path.join(sparse_dir, "images.txt"))
    else:
        raise ValueError(f"model extension {ext!r}: .bin or .txt")


def camera_K(camera: Camera) -> np.ndarray:
    """Intrinsics matrix from a COLMAP camera (pinhole family only)."""
    if camera.model in ("SIMPLE_RADIAL", "SIMPLE_PINHOLE"):
        f, cx, cy = camera.params[:3]
        return np.asarray([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float32)
    if camera.model == "PINHOLE":
        fx, fy, cx, cy = camera.params[:4]
        return np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    raise NotImplementedError(f"camera model {camera.model}")
