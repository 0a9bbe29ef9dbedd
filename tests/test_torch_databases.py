"""The port's readers of every database family against nero_tpu's, on
fixtures written to tmp_path (the families' data is not in the repository):
GlossySynthetic with 16-bit depth PNGs and the pickled test split,
NeRF-synthetic RGBA frames on black and on white, GlossyReal (`bear`'s up
and forward) and a custom object, both raw and cropped. Images, depths,
intrinsics, poses, normalisation and splits are compared to the bit; each
package reads the parse and crop caches that the other wrote; every family
has its own copy of the fixture, so caches cross only where a test means
them to."""
import json
import os
import pickle
import shutil

import numpy as np
import pytest

import nero_tpu.dataset.database as JD
import nero_tpu_torch.dataset.database as TD
from nero_tpu.dataset.colmap_model import Camera, Image, rotmat2qvec, write_model
from nero_tpu.geometry.mesh_io import write_ply
from nero_tpu.utils.image import imsave
from nero_tpu.utils.pose import look_at_pose

N_SYN = 128          # GlossySynthetic views: the pickled split names ids up to 127
SYN_RES = 12


@pytest.fixture()
def data_root(tmp_path, monkeypatch):
    """One database root for both packages."""
    monkeypatch.setattr(JD, "DATA_ROOT", str(tmp_path))
    monkeypatch.setattr(TD, "DATA_ROOT", str(tmp_path))
    return tmp_path


def _both(name):
    return TD.parse_database_name(name), JD.parse_database_name(name)


def _assert_views_equal(port, ref, ids=None, depth=True):
    assert port.get_img_ids() == ref.get_img_ids()
    for i in (ids if ids is not None else ref.get_img_ids()):
        a, b = port.get_image(i), ref.get_image(i)
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
        for get in ("get_K", "get_pose"):
            a, b = getattr(port, get)(i), getattr(ref, get)(i)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        if depth:
            for a, b in zip(port.get_depth(i), ref.get_depth(i)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ GlossySynthetic

def _write_glossy_synthetic(root):
    """N_SYN views of 12 x 12 px: <k>.png (RGBA, as Blender writes),
    <k>-camera.pkl (pose, K) and a 16-bit <k>-depth.png, some of it beyond
    the 14.5 background threshold."""
    root.mkdir(parents=True)
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[:SYN_RES, :SYN_RES]
    for k in range(N_SYN):
        az = 2 * np.pi * k / N_SYN
        pose = look_at_pose(np.asarray([3 * np.cos(az), 3 * np.sin(az), 0.5 + k / N_SYN]),
                            np.zeros(3))
        K = np.asarray([[14.0, 0, 6.0], [0, 14.0, 6.0], [0, 0, 1]], np.float32)
        with open(root / f"{k}-camera.pkl", "wb") as f:
            pickle.dump((pose, K), f)
        imsave(str(root / f"{k}.png"), rng.randint(0, 255, (SYN_RES, SYN_RES, 4), np.uint8))
        disc = (yy - 6) ** 2 + (xx - 6) ** 2 < 16
        depth = np.where(disc, (2.5 + rng.rand(SYN_RES, SYN_RES)) / 15, 1.0)
        imsave(str(root / f"{k}-depth.png"), (depth * 65535).astype(np.uint16))


def test_glossy_synthetic_views_and_splits(data_root):
    _write_glossy_synthetic(data_root / "GlossySynthetic" / "toy")
    port, ref = _both("syn/toy")
    assert isinstance(port, TD.GlossySyntheticDatabase)
    assert len(port.get_img_ids()) == N_SYN
    _assert_views_equal(port, ref, ids=["0", "7", "127"])
    depth, mask = port.get_depth("7")
    assert depth.max() == 15.0 and mask.any() and not mask.all()
    for split in ("validation", "test"):
        assert TD.get_database_split(port, split) == JD.get_database_split(ref, split)
    train, test = TD.get_database_split(port, "test")
    assert (len(train), len(test)) == (96, 32)
    with pytest.raises(NotImplementedError):
        TD.get_database_split(port, "train")


def test_glossy_synthetic_eval_points_and_their_cache(data_root):
    """get_database_eval_points fuses the test views' depths into the same
    cloud as nero_tpu's, caches it in eval_pts.npy, and each package reads
    the cache that the other wrote."""
    for name in ("a", "b"):
        _write_glossy_synthetic(data_root / "GlossySynthetic" / name)
    port = TD.get_database_eval_points(TD.parse_database_name("syn/a"))
    ref = JD.get_database_eval_points(JD.parse_database_name("syn/b"))
    assert port.dtype == ref.dtype == np.float32 and len(port) > 100
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(np.load(data_root / "GlossySynthetic" / "a" / "eval_pts.npy"),
                                  port)
    # the other package's cache, marked so that a recomputation would show
    for name, fuse in (("a", JD), ("b", TD)):
        cache = data_root / "GlossySynthetic" / name / "eval_pts.npy"
        marked = np.load(cache) + np.float32(0.25)
        np.save(cache, marked)
        np.testing.assert_array_equal(
            fuse.get_database_eval_points(fuse.parse_database_name(f"syn/{name}")), marked)


# ------------------------------------------------------------ NeRF-synthetic

def _write_nerf_synthetic(root, res: int = 16):
    rng = np.random.RandomState(1)
    for split, n in (("train", 3), ("test", 2)):
        (root / split).mkdir(parents=True)
        frames = []
        for i in range(n):
            c2w = np.eye(4)
            c2w[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0]
            c2w[:3, 3] = rng.randn(3) * 3
            frames.append({"file_path": f"{split}/r_{i}", "transform_matrix": c2w.tolist()})
            rgba = rng.randint(0, 255, (res, res, 4), np.uint8)
            rgba[: res // 4, :, 3] = 0       # transparent rows
            rgba[-res // 4:, :, 3] = 255     # opaque rows
            imsave(str(root / split / f"r_{i}.png"), rgba)
        with open(root / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.69, "frames": frames}, f)


@pytest.mark.parametrize("spec", ["black_16", "white_16", "white_8"])
def test_nerf_synthetic_views(data_root, spec):
    _write_nerf_synthetic(data_root / "nerf_synthetic" / "toy")
    port, ref = _both(f"nerf_synthetic/toy/{spec}")
    assert isinstance(port, TD.NeRFSyntheticDatabase)
    assert port.get_img_ids() == ["train-0", "train-1", "train-2", "test-0", "test-1"]
    _assert_views_equal(port, ref)
    img = port.get_image("test-1")
    res = int(spec.split("_")[1])
    assert img.shape == (res, res, 3)
    if res == 16:
        assert (img[0] == (0 if spec.startswith("black") else 255)).all()
    assert TD.get_database_split(port) == JD.get_database_split(ref)


# ------------------------------------------------------------ COLMAP objects

def _write_colmap_object(root, centre, n_views: int = 4, h: int = 48, w: int = 64):
    """A COLMAP capture: SIMPLE_RADIAL views around a blob of radius 0.8 at
    `centre`, random images, the blob as the object's point cloud."""
    (root / "images").mkdir(parents=True)
    rng = np.random.RandomState(2)
    f = 60.0
    cameras = {1: Camera(1, "SIMPLE_RADIAL", w, h, np.asarray([f, w / 2, h / 2, 0.0]))}
    images = {}
    for i in range(1, n_views + 1):
        az = 2 * np.pi * i / n_views
        eye = np.asarray([4 * np.cos(az), 4 * np.sin(az), 2.0]) + centre
        pose = look_at_pose(eye, centre + rng.randn(3) * 0.05)
        images[i] = Image(i, rotmat2qvec(pose[:, :3]), pose[:, 3].astype(np.float64), 1,
                          f"img_{i}.png")
        imsave(str(root / "images" / f"img_{i}.png"), rng.randint(0, 255, (h, w, 3), np.uint8))
    write_model(cameras, images, str(root / "colmap" / "sparse" / "0"))
    pts = rng.normal(size=(500, 3))
    pts = pts / np.linalg.norm(pts, axis=-1, keepdims=True) * 0.8 + centre
    write_ply(str(root / "object_point_cloud.ply"), pts.astype(np.float32))
    return root


def _write_custom(root):
    _write_colmap_object(root, np.asarray([1.0, 2.0, 3.0]))
    np.savetxt(str(root / "meta_info.txt"), np.asarray([[0.0, 0.2, 1.0], [1.0, 0.0, 0.1]]))


FAMILIES = {
    "real": (lambda r, n: _write_colmap_object(r / "GlossyReal" / "bear",
                                               np.asarray([0.3, -0.2, 0.5])), "bear"),
    "custom": (lambda r, n: _write_custom(r / "custom" / n), None),
}


def _colmap_root(data_root, family, name):
    return data_root / "GlossyReal" / "bear" if family == "real" else data_root / family / name


def _assert_normalisation_equal(port, ref):
    for k in ("ref_points", "R_rect", "offset_rect"):
        a, b = getattr(port, k), getattr(ref, k)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert port.scale_rect == ref.scale_rect


@pytest.mark.parametrize("family", ["real", "custom"])
@pytest.mark.parametrize("max_len", ["raw_32", "raw_64", "24"])
def test_colmap_object_views_and_normalisation(tmp_path, monkeypatch, family, max_len):
    """Each package on its own copy of the capture: the same images, K,
    poses, normalisation and validation split."""
    write, fixed = FAMILIES[family]
    dbs = []
    for pkg, mod in (("port", TD), ("jax", JD)):
        root = tmp_path / pkg
        write(root, "toy")
        monkeypatch.setattr(mod, "DATA_ROOT", str(root))
        dbs.append(mod.parse_database_name(f"{family}/{fixed or 'toy'}/{max_len}"))
    port, ref = dbs
    assert type(port).__name__ == type(ref).__name__
    _assert_views_equal(port, ref)
    _assert_normalisation_equal(port, ref)
    assert TD.get_database_split(port) == JD.get_database_split(ref)
    r = np.linalg.norm(port.ref_points, axis=-1)
    assert abs(r.max() - 1.0) < 1e-6
    img = port.get_image(port.get_img_ids()[0])
    if max_len == "24":
        assert img.shape == (24, 24, 3)
    else:
        assert max(img.shape[:2]) == int(max_len.split("_")[1])
    with pytest.raises(NotImplementedError):
        TD.get_database_eval_points(port)


@pytest.mark.parametrize("family", ["real", "custom"])
@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("max_len", ["raw_32", "24"])
def test_colmap_object_reads_the_other_packages_caches(data_root, family, writer, max_len):
    """One package parses (cache.pkl) and crops or resizes (images_<n>/,
    with meta_info.pkl for a crop); the sparse model, and for a crop the
    source images, are then removed, so that the other package can only
    read the caches: it serves the same views."""
    write, fixed = FAMILIES[family]
    write(data_root, "toy")
    name = f"{family}/{fixed or 'toy'}/{max_len}"
    first, second = (JD, TD) if writer == "jax" else (TD, JD)
    made = first.parse_database_name(name)
    root = _colmap_root(data_root, family, "toy")
    assert (root / "cache.pkl").exists()
    shutil.rmtree(root / "colmap")
    if max_len == "24":
        assert (root / "images_24" / "meta_info.pkl").exists()
        shutil.rmtree(root / "images")
    read = second.parse_database_name(name)
    port, ref = (read, made) if writer == "jax" else (made, read)
    _assert_views_equal(port, ref)
    _assert_normalisation_equal(port, ref)
    # the caches hold plain lists and dicts of numpy arrays
    with open(root / "cache.pkl", "rb") as f:
        poses, Ks, names, ids = pickle.load(f)
    assert isinstance(poses, dict) and isinstance(ids, list)
    assert all(type(v) is np.ndarray for v in list(poses.values()) + list(Ks.values()))


def test_custom_raw_rescales_intrinsics_at_ratio_one(data_root):
    """raw_<longest side> keeps the images' size but still multiplies K by
    the (unit) resize factors, in both packages."""
    _write_custom(data_root / "custom" / "toy")
    port, ref = _both("custom/toy/raw_64")
    _assert_views_equal(port, ref)
    i = port.get_img_ids()[0]
    assert port.get_image(i).shape == (48, 64, 3)
    np.testing.assert_array_equal(port.get_K(i)[:2, :2], np.diag([60.0, 60.0]).astype(np.float32))


def test_every_family_is_parsed(data_root):
    assert isinstance(TD.parse_database_name("proc/sphere/32_6"), TD.ProceduralDatabase)
    with pytest.raises(NotImplementedError):
        TD.parse_database_name("llff/fern")
    families = {"syn": "GlossySyntheticDatabase", "real": "GlossyRealDatabase",
                "custom": "CustomDatabase", "proc": "ProceduralDatabase",
                "nerf_synthetic": "NeRFSyntheticDatabase"}
    for family, cls in families.items():
        assert hasattr(TD, cls) and hasattr(JD, cls), family


def test_data_root_follows_the_environment(tmp_path):
    import subprocess
    import sys
    code = ("import nero_tpu_torch.dataset.database as d, nero_tpu.dataset.database as j; "
            "print(d.DATA_ROOT == j.DATA_ROOT, d.DATA_ROOT)")
    env = {**os.environ, "NERO_TPU_DATA_ROOT": str(tmp_path), "JAX_PLATFORMS": "cpu"}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env, capture_output=True,
                         text=True, check=True, timeout=120).stdout.split()
    assert out == ["True", str(tmp_path)]
