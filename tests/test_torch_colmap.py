"""The port's COLMAP readers and writers, its sqlite database writer, the
pose and image helpers of the crop path, and its two subprocess wrappers
(`run_colmap`, `relight`), each held against nero_tpu on the same seeded
inputs: files written by one package are read by the other, arrays compared
to the bit, command lines compared argument by argument."""
import os
import sqlite3
import stat
import struct
import sys

import numpy as np
import pytest

import nero_tpu.dataset.colmap_db as JDB
import nero_tpu.dataset.colmap_model as JM
import nero_tpu.utils.image as JI
import nero_tpu.utils.pose as JP
import nero_tpu_torch.dataset.colmap_db as TDB
import nero_tpu_torch.dataset.colmap_model as TM
import nero_tpu_torch.utils.image as TI
import nero_tpu_torch.utils.pose as TP


def _rotation(rng) -> np.ndarray:
    q = rng.randn(4)
    return JM.qvec2rotmat(q / np.linalg.norm(q))


def _model(M, rng, n_images: int = 5):
    """Three cameras of the pinhole family and `n_images` posed images, as
    package M's dataclasses."""
    cameras = {
        1: M.Camera(1, "SIMPLE_RADIAL", 640, 480, np.asarray([812.5, 320.25, 239.75, 0.01])),
        2: M.Camera(2, "PINHOLE", 300, 200, np.asarray([401.0, 399.5, 150.0, 100.0])),
        5: M.Camera(5, "SIMPLE_PINHOLE", 64, 48, np.asarray([60.0, 32.0, 24.0])),
    }
    images = {}
    for i in range(n_images):
        img_id = 3 * i + 2
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        images[img_id] = M.Image(img_id, q, rng.randn(3), [1, 2, 5][i % 3], f"view_{i:03d}.png")
    return cameras, images


def _assert_models_equal(a, b):
    cams_a, imgs_a = a
    cams_b, imgs_b = b
    assert list(cams_a) == list(cams_b) and list(imgs_a) == list(imgs_b)
    for k in cams_a:
        ca, cb = cams_a[k], cams_b[k]
        assert (ca.id, ca.model, ca.width, ca.height) == (cb.id, cb.model, cb.width, cb.height)
        np.testing.assert_array_equal(ca.params, cb.params)
    for k in imgs_a:
        ia, ib = imgs_a[k], imgs_b[k]
        assert (ia.id, ia.camera_id, ia.name) == (ib.id, ib.camera_id, ib.name)
        np.testing.assert_array_equal(ia.qvec, ib.qvec)
        np.testing.assert_array_equal(ia.tvec, ib.tvec)


@pytest.mark.parametrize("writer, reader", [(JM, TM), (TM, JM)], ids=["jax_to_port", "port_to_jax"])
def test_binary_model_read_by_the_other_package(tmp_path, writer, reader):
    cameras, images = _model(writer, np.random.RandomState(0))
    writer.write_model(cameras, images, str(tmp_path))
    cams, imgs, points = reader.read_model(str(tmp_path))
    assert points is None
    _assert_models_equal((cameras, images), (cams, imgs))
    for cam in cams.values():
        np.testing.assert_array_equal(TM.camera_K(cam), JM.camera_K(cam))


def test_binary_model_files_are_the_same_bytes(tmp_path):
    for name, M in (("jax", JM), ("port", TM)):
        M.write_model(*_model(M, np.random.RandomState(1)), str(tmp_path / name))
    for f in ("cameras.bin", "images.bin"):
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes(), f


def test_binary_points_read_by_both(tmp_path):
    rng = np.random.RandomState(2)
    TM.write_model(*_model(TM, rng), str(tmp_path))
    xyz = rng.randn(7, 3)
    with open(tmp_path / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i, p in enumerate(xyz):
            track = rng.randint(0, 9, size=2 * (i % 3 + 1))
            f.write(struct.pack("<Q3d3Bd", i + 1, *p, 10, 20, 30, 0.5))
            f.write(struct.pack("<Q", len(track) // 2) + struct.pack(f"<{len(track)}i", *track))
    pts_t = TM.read_model(str(tmp_path))[2]
    pts_j = JM.read_model(str(tmp_path))[2]
    np.testing.assert_array_equal(pts_t, pts_j)
    np.testing.assert_array_equal(pts_t, xyz)


def test_text_model_read_by_both(tmp_path):
    """COLMAP's text layout, every image with its observations on the
    second line: both packages read the same model."""
    rng = np.random.RandomState(3)
    cameras, images = _model(JM, rng)
    lines = ["# Camera list", "# Number of cameras: 3"]
    lines += [f"{c.id} {c.model} {c.width} {c.height} " + " ".join(repr(float(p)) for p in c.params)
              for c in cameras.values()]
    (tmp_path / "cameras.txt").write_text("\n".join(lines) + "\n")
    lines = ["# Image list with two lines of data per image:", "# Number of images: 5"]
    for img in images.values():
        lines.append(f"{img.id} " + " ".join(repr(float(v)) for v in (*img.qvec, *img.tvec))
                     + f" {img.camera_id} {img.name}")
        lines.append(" ".join(f"{x:.2f} {y:.2f} {k}" for x, y, k in
                              zip(rng.rand(3) * 300, rng.rand(3) * 200, rng.randint(-1, 9, 3))))
    (tmp_path / "images.txt").write_text("\n".join(lines) + "\n")
    port, ref = TM.read_model(str(tmp_path)), JM.read_model(str(tmp_path))
    _assert_models_equal(port[:2], ref[:2])
    _assert_models_equal(port[:2], (cameras, images))


def test_text_model_round_trip_with_images_without_points(tmp_path):
    """The port's text writer gives each image an empty 2-D point line, as
    COLMAP does for an image with no observation; its reader takes that line
    as the image's points, so every image comes back."""
    cameras, images = _model(TM, np.random.RandomState(4), n_images=6)
    TM.write_model(cameras, images, str(tmp_path), ext=".txt")
    assert not (tmp_path / "cameras.bin").exists()
    _assert_models_equal(TM.read_model(str(tmp_path))[:2], (cameras, images))
    with pytest.raises(ValueError):
        TM.write_model(cameras, images, str(tmp_path), ext=".json")


def test_text_model_of_one_image_read_by_jax(tmp_path):
    cameras, images = _model(TM, np.random.RandomState(5), n_images=1)
    TM.write_model(cameras, images, str(tmp_path), ext=".txt")
    _assert_models_equal(JM.read_model(str(tmp_path))[:2], (cameras, images))


def test_qvec_round_trip_matches_jax():
    rng = np.random.RandomState(6)
    for _ in range(20):
        R = _rotation(rng)
        q_t, q_j = TM.rotmat2qvec(R), JM.rotmat2qvec(R)
        np.testing.assert_array_equal(q_t, q_j)
        assert q_t[0] >= 0
        np.testing.assert_array_equal(TM.qvec2rotmat(q_t), JM.qvec2rotmat(q_j))
        np.testing.assert_allclose(TM.qvec2rotmat(q_t), R, atol=1e-12)


def _dump_tables(path):
    conn = sqlite3.connect(path)
    schema = conn.execute("SELECT type, name, sql FROM sqlite_master ORDER BY name").fetchall()
    rows = {name: conn.execute(f"SELECT * FROM {name}").fetchall()
            for kind, name, _ in schema if kind == "table" and not name.startswith("sqlite_")}
    conn.close()
    return schema, rows


def test_colmap_database_tables_match_jax(tmp_path):
    for name, D in (("jax", JDB), ("port", TDB)):
        db = D.COLMAPDatabase(str(tmp_path / f"{name}.db"))
        db.add_camera("SIMPLE_RADIAL", 640, 480, [800.0, 320, 240, 0.0], camera_id=1)
        db.add_camera("PINHOLE", 64, 48, [60.0, 61.0, 32, 24], prior_focal_length=False)
        for i in range(3):
            db.add_image(f"img{i}.png", 1 + i % 2, image_id=i + 1)
        db.add_image("extra.png", 2)
        db.commit()
        db.close()
    port, ref = _dump_tables(tmp_path / "port.db"), _dump_tables(tmp_path / "jax.db")
    assert port == ref
    assert port[1]["cameras"][0][:4] == (1, 2, 640, 480)
    assert [r[:3] for r in port[1]["images"]] == [(1, "img0.png", 1), (2, "img1.png", 2),
                                                  (3, "img2.png", 1), (4, "extra.png", 2)]


def test_pose_helpers_match_jax():
    rng = np.random.RandomState(7)
    pts = rng.randn(50, 3)
    for _ in range(5):
        pose = np.concatenate([_rotation(rng), rng.randn(3, 1) + [[0], [0], [4]]], 1)
        K = np.asarray([[rng.uniform(50, 90), 0, 32.5], [0, rng.uniform(50, 90), 24.5], [0, 0, 1]])
        for a, b in zip(TP.project_points(pts, pose, K), JP.project_points(pts, pose, K)):
            np.testing.assert_array_equal(a, b)
        p2 = rng.randn(2) * 0.3
        np.testing.assert_array_equal(TP.image_plane_look_at_rotation(p2),
                                      JP.image_plane_look_at_rotation(p2))
        pose2 = np.concatenate([_rotation(rng), rng.randn(3, 1)], 1)
        assert TP.pose_errors(pose, pose2) == JP.pose_errors(pose, pose2)
        assert TP.rotation_angle_deg(pose[:, :3], pose2[:, :3]) == \
            JP.rotation_angle_deg(pose[:, :3], pose2[:, :3])
    errors = rng.rand(40) * 25
    assert TP.pose_auc(errors) == JP.pose_auc(errors)
    assert TP.pose_auc(errors, (1.0, 30.0)) == JP.pose_auc(errors, (1.0, 30.0))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_image_helpers_match_jax(dtype):
    rng = np.random.RandomState(8)
    img = rng.randint(0, 255, (37, 45, 3)).astype(dtype)
    H = np.asarray([[1.05, 0.02, -3.0], [-0.01, 0.97, 2.5], [1e-4, -2e-4, 1.0]])
    np.testing.assert_array_equal(TI.warp_perspective(img, H, (30, 28)),
                                  JI.warp_perspective(img, H, (30, 28)))
    np.testing.assert_array_equal(TI.warp_perspective(img[..., 0], H, (30, 28)),
                                  JI.warp_perspective(img[..., 0], H, (30, 28)))
    for ratio in (0.4, 0.75, 1.0, 1.5):
        a, b = TI.resize_img(img, ratio), JI.resize_img(img, ratio)
        assert a.dtype == b.dtype == img.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scale, angle", [(0.6, 0.0), (1.3, 0.2)])
def test_look_at_crop_matches_jax(scale, angle):
    rng = np.random.RandomState(9)
    img = rng.randint(0, 255, (48, 64, 3)).astype(np.uint8)
    K = np.asarray([[60.0, 0, 32.0], [0, 62.0, 24.0], [0, 0, 1]], np.float32)
    pose = np.concatenate([_rotation(rng), rng.randn(3, 1)], 1).astype(np.float32)
    pos = np.asarray([30.5, 20.25], np.float32)
    out_t = TP.look_at_crop(img, K, pose, pos, angle, scale, 24, 24)
    out_j = JP.look_at_crop(img, K, pose, pos, angle, scale, 24, 24)
    for a, b in zip(out_t, out_j):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert out_t[0].shape == (24, 24, 3)
    np.testing.assert_allclose(out_t[1][:2, 2], [12.0, 12.0])


# ------------------------------------------------------------ subprocesses

def _fake_tool(tmp_path, name: str) -> str:
    """An executable that appends its argv (one JSON list a line) to
    <tmp_path>/<name>.log."""
    path = tmp_path / "bin" / name
    path.parent.mkdir(exist_ok=True)
    path.write_text(f"#!{sys.executable}\nimport json, sys\n"
                    f"open({str(tmp_path / (name + '.log'))!r}, 'a').write("
                    "json.dumps(sys.argv[1:]) + '\\n')\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def _project(root, rng):
    (root / "images").mkdir(parents=True)
    for i in range(3):
        TI.imsave(str(root / "images" / f"{i:02d}.jpg"),
                  rng.randint(0, 255, (40, 56, 3)).astype(np.uint8))
    return root


@pytest.mark.parametrize("dense", [True, False])
def test_run_sfm_runs_the_same_commands(tmp_path, dense):
    import run_colmap as root_cli

    from nero_tpu_torch import run_colmap

    colmap = _fake_tool(tmp_path, "colmap")
    rng = np.random.RandomState(10)
    ref_dir, port_dir = _project(tmp_path / "ref", rng), _project(tmp_path / "port", rng)
    root_cli.run_sfm(str(ref_dir), colmap=colmap, dense=dense)
    log = (tmp_path / "colmap.log").read_text()
    (tmp_path / "colmap.log").unlink()
    run_colmap.run_sfm(str(port_dir), colmap=colmap, dense=dense)
    port_log = (tmp_path / "colmap.log").read_text()
    assert port_log == log.replace(str(ref_dir), str(port_dir))
    assert len(port_log.splitlines()) == (6 if dense else 3)
    assert _dump_tables(port_dir / "colmap" / "database.db") == \
        _dump_tables(ref_dir / "colmap" / "database.db")


@pytest.mark.parametrize("trans", [False, True])
def test_relight_runs_the_same_command(tmp_path, monkeypatch, trans):
    import relight as root_cli

    from nero_tpu_torch import relight

    blender = _fake_tool(tmp_path, "blender")
    argv = ["--blender", blender, "--name", "bell-neon", "--mesh", "m.ply",
            "--material", "mats/", "--hdr", "neon.exr"] + (["--trans"] if trans else [])
    monkeypatch.setattr(sys, "argv", ["relight.py"] + argv)
    root_cli.main()
    relight.main(argv)
    ref, port = (tmp_path / "blender.log").read_text().splitlines()
    assert port == ref
    assert os.path.join("blender_backend", "relight_backend.py") in port


def test_subprocess_wrappers_refuse_a_missing_binary(tmp_path):
    from nero_tpu_torch import relight, run_colmap

    with pytest.raises(SystemExit):
        run_colmap.main(["--project_dir", str(tmp_path), "--colmap", str(tmp_path / "none")])
    with pytest.raises(SystemExit):
        relight.main(["--blender", str(tmp_path / "none"), "--name", "a", "--mesh", "m",
                      "--material", "d", "--hdr", "h"])
