"""Extraction and evaluation of the port against nero_tpu on the CPU: the SDF
grid and its meshes, the Chamfer distance, the evaluation cloud and its
helpers, the UV atlases and the OBJ/MTL export, Stage I's per-vertex
materials, the `val_geometry` snapshot of `test_step`, and the texture bake,
on the same inputs (numpy, from a seed) and the same parameters (nero_tpu's
init through core/convert.py)."""
import jax
import numpy as np
import pytest
import torch

import extract_materials_texture_map as jax_bake
from nero_tpu.dataset import database as JD
from nero_tpu.fields.sdf import SDFConfig as JaxSDFConfig
from nero_tpu.fields.sdf import init_sdf as jax_init_sdf
from nero_tpu.fields.sdf import sdf_value as jax_sdf_value
from nero_tpu.geometry import chamfer as JC
from nero_tpu.geometry import isosurface as JI
from nero_tpu.geometry import uv_atlas as JU
from nero_tpu.models.material import NeROMaterialModel as JaxMaterialModel
from nero_tpu.models.shape import NeROShapeModel as JaxShapeModel
from nero_tpu.utils import pose as JP
from nero_tpu_torch import extract_materials_texture_map as bake
from nero_tpu_torch.core.convert import from_numpy_tree, tree_map
from nero_tpu_torch.dataset import database as TD
from nero_tpu_torch.fields.sdf import SDFConfig, sdf_value
from nero_tpu_torch.geometry import chamfer as TC
from nero_tpu_torch.geometry import isosurface as TI
from nero_tpu_torch.geometry import uv_atlas as TU
from nero_tpu_torch.geometry.native import rasterize_uv
from nero_tpu_torch.geometry.proc_mesh import proc_mesh
from nero_tpu_torch.models.material import NeROMaterialModel
from nero_tpu_torch.models.shape import NeROShapeModel
from nero_tpu_torch.utils import pose as TP

# one intra-op thread: the suite runs several worker processes side by side
torch.set_num_threads(1)

BOX = ([-1.01, -1.01, -1.01], [1.01, 1.01, 1.01])
GRID_TOL = 2e-5        # max |grid difference|: the port's sdf_value parity bar
MESH_CHAMFER_TOL = 1e-4
CHAMFER_RTOL = 1e-5
MATERIAL_ATOL = 1e-5
TEXTURE_ATOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_tree(tree):
    return from_numpy_tree(tree_map(np.asarray, tree), requires_grad=False)


@pytest.fixture(scope="module")
def full_sdf():
    """The full-width 8 x 256 SDF of nero_tpu's init, in both packages."""
    params = _np_tree(jax_init_sdf(jax.random.PRNGKey(0), JaxSDFConfig()))
    return params, _torch_tree(params)


def _jax_query(params):
    return lambda p: jax_sdf_value(params, p, JaxSDFConfig())


def _torch_query(params):
    return lambda p: sdf_value(params, p, SDFConfig())


def test_extract_fields_matches(full_sdf):
    pj, pt = full_sdf
    uj = JI.extract_fields(*BOX, 32, _jax_query(pj), chunk=32 ** 3)
    ut = TI.extract_fields(*BOX, 32, _torch_query(pt), device="cpu")
    assert ut.shape == uj.shape == (32, 32, 32) and ut.dtype == np.float32
    assert (ut == 1.0).sum() == (uj == 1.0).sum() > 0   # the clamp outside the unit sphere
    assert np.abs(ut - uj).max() <= GRID_TOL


@pytest.mark.parametrize("method", ["surface_nets", "marching_tets"])
def test_meshes_match(full_sdf, method):
    pj, pt = full_sdf
    vj, tj = JI.extract_geometry(*BOX, 32, 0.0, _jax_query(pj), method=method)
    vt, tt = TI.extract_geometry(*BOX, 32, 0.0, _torch_query(pt), method=method,
                                 device="cpu")
    assert vt.dtype == np.float32 and tt.shape[1] == 3 and len(vj) > 100
    assert abs(len(vt) - len(vj)) <= 0.01 * len(vj)
    assert abs(len(tt) - len(tj)) <= 0.01 * len(tj)
    chamfer, _, _ = TC.chamfer_distance(vt, vj, device="cpu")
    assert chamfer <= MESH_CHAMFER_TOL


@pytest.mark.parametrize("n", [1000, 9000])   # 9000 crosses the 8,192-row chunk edge
def test_chamfer_matches(n):
    rng = np.random.RandomState(n)
    a = rng.randn(n, 3).astype(np.float32)
    b = (rng.randn(n + 37, 3) * 0.9 + 0.05).astype(np.float32)
    want = JC.chamfer_distance(a, b)
    got = TC.chamfer_distance(a, b, device="cpu")
    np.testing.assert_allclose(got, [float(w) for w in want], rtol=CHAMFER_RTOL)
    # per point, the squared distances within the rounding of the form
    # |q|^2 - 2 q.r + |r|^2: a few f32 ulps of (|q| + |r|)^2, |r| <= |q| + d
    dt, dj = TC.nearest_dist(a, b, device="cpu"), np.asarray(JC.nearest_dist(a, b))
    bound = 8 * np.finfo(np.float32).eps * (2 * np.linalg.norm(a, axis=1) + dj) ** 2
    assert (np.abs(dt.astype(np.float64) ** 2 - dj.astype(np.float64) ** 2) <= bound).all()


def test_voxel_downsample_matches():
    pts = (np.random.RandomState(0).rand(5000, 3) * 0.3).astype(np.float32)
    np.testing.assert_array_equal(TD.voxel_downsample(pts, 0.01), JD.voxel_downsample(pts, 0.01))


def test_eval_points_match():
    name = "proc/sphere/48_6"
    got = TD.get_database_eval_points(TD.parse_database_name(name))
    want = JD.get_database_eval_points(JD.parse_database_name(name))
    assert len(want) > 200
    np.testing.assert_array_equal(got, want)


def test_eval_points_refuse_unported_families():
    """A family without depth maps has no evaluation cloud, in both
    packages (GlossySynthetic's is tested in test_torch_databases.py)."""
    class Other(TD.BaseDatabase):
        get_image = get_K = get_pose = get_img_ids = get_depth = lambda *a: None
    with pytest.raises(NotImplementedError, match="Other: only GlossySynthetic and procedural"):
        TD.get_database_eval_points(Other("syn/bell"))


def test_pose_helpers_match():
    rng = np.random.RandomState(3)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    p0 = np.concatenate([q, rng.randn(3, 1)], 1)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    p1 = np.concatenate([q, rng.randn(3, 1)], 1)
    pts = rng.randn(100, 3)
    np.testing.assert_array_equal(TP.pose_inverse(p0), JP.pose_inverse(p0))
    np.testing.assert_array_equal(TP.pose_compose(p0, p1), JP.pose_compose(p0, p1))
    np.testing.assert_array_equal(TP.pose_apply(p0, pts), JP.pose_apply(p0, pts))
    mask = rng.rand(12, 16) > 0.5
    depth = rng.rand(12, 16).astype(np.float32) + 1.0
    K = np.asarray([[20.0, 0, 8], [0, 20.0, 6], [0, 0, 1]])
    np.testing.assert_array_equal(TP.mask_depth_to_pts(mask, depth, K),
                                  JP.mask_depth_to_pts(mask, depth, K))


@pytest.fixture(scope="module")
def small_mesh():
    return proc_mesh("sphere", grid=24, lo=-1.0, hi=1.0)


@pytest.mark.parametrize("what", ["triangle_atlas", "chart_atlas", "knn_inpaint"])
def test_atlas_matches(small_mesh, what):
    verts, tris = small_mesh["vertices"], small_mesh["triangles"]
    if what == "triangle_atlas":
        got, want = TU.triangle_atlas(tris), JU.triangle_atlas(tris)
    elif what == "chart_atlas":
        got = TU.chart_atlas(verts, tris, resolution=128)
        want = JU.chart_atlas(verts, tris, resolution=128)
    else:
        uv, uv_tris, vert_map = TU.chart_atlas(verts, tris, resolution=64)
        img, mask = rasterize_uv(uv, uv_tris, verts[vert_map], 64, 64)
        assert 0 < mask.mean() < 1
        got, want = (TU.knn_inpaint(img, mask),), (JU.knn_inpaint(img, mask),)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_obj_mtl_export_is_byte_equal(small_mesh, tmp_path):
    verts, tris = small_mesh["vertices"], small_mesh["triangles"]
    uv, uv_tris, vert_map = TU.triangle_atlas(tris)
    for pkg, mod in (("port", TU), ("jax", JU)):
        (tmp_path / pkg).mkdir()
        mod.export_mtl(str(tmp_path / pkg / "material.mtl"), albedo="a.jpg")
        mod.export_obj(str(tmp_path / pkg / "mesh.obj"), verts, tris, uv, uv_tris, vert_map,
                       mtl_file="material.mtl")
    for name in ("material.mtl", "mesh.obj"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_stage1_materials_match():
    """Stage I's per-vertex materials at full width (8 x 256 SDF features
    through the 259 -> 1 / 1 / 3 heads) at 1,001 vertices."""
    cfg = {"name": "mat", "database_name": "proc/sphere/32_6"}
    jm = JaxShapeModel(dict(cfg), training=False)
    tm = NeROShapeModel(dict(cfg), training=False, device="cpu")
    tm.params = _torch_tree(_np_tree(jm.params))
    verts = np.random.RandomState(5).uniform(-0.6, 0.6, (1001, 3)).astype(np.float32)
    want = jm.predict_materials(vertices=verts)
    got = tm.predict_materials(vertices=verts)
    assert set(got) == set(want) == {"metallic", "roughness", "albedo"}
    for k in want:
        assert got[k].shape == want[k].shape == (1001, 3 if k == "albedo" else 1)
        np.testing.assert_allclose(got[k], want[k], atol=MATERIAL_ATOL, err_msg=k)


def test_val_geometry_snapshot_matches():
    """`test_step` with val_geometry on a narrow SDF (2 layers of width 64):
    the 128^3 mesh of the first validation view, in both packages."""
    cfg = {"name": "val_geo", "database_name": "proc/sphere/32_6", "n_samples": 16,
           "n_importance": 8, "up_sample_steps": 2, "n_bg_samples": 4, "test_ray_num": 256,
           "downsample_ratio": 0.5, "val_geometry": True, "sdf_n_layers": 2}
    jm = JaxShapeModel(dict(cfg), training=True)
    narrow = JaxSDFConfig(n_layers=2, skip=1, d_hidden=64)
    jparams = dict(jm.params, sdf=jax_init_sdf(jax.random.PRNGKey(1), narrow))
    tm = NeROShapeModel(dict(cfg), training=True, device="cpu")
    tm.params = _torch_tree(_np_tree(jparams))
    want = jm.test_step(jparams, 0, step=10)
    got = tm.test_step(tm.params, 0, step=10)
    assert len(want["vertices"]) > 1000
    assert len(got["vertices"]) == len(want["vertices"])
    assert got["triangles"].shape[1] == 3
    chamfer, _, _ = TC.chamfer_distance(got["vertices"], want["vertices"], device="cpu")
    assert chamfer <= MESH_CHAMFER_TOL


@pytest.mark.parametrize("atlas", ["charts", "per_triangle"])
def test_bake_textures_matches(small_mesh, atlas):
    """The texture bake at resolution 64 with Stage-II parameters of
    nero_tpu's init: the float textures before JPEG encoding."""
    cfg = {"name": "bake", "database_name": "proc/sphere/32_6", "mesh": small_mesh,
           "tracer": "bvh"}
    jm = JaxMaterialModel(dict(cfg), training=False)
    tm = NeROMaterialModel(dict(cfg), training=False, device="cpu")
    tm.params = _torch_tree(_np_tree(jm.params))
    want = jax_bake.bake_textures(jm, jm.params, resolution=64, atlas=atlas, verbose=False)
    got = bake.bake_textures(tm, tm.params, resolution=64, atlas=atlas, verbose=False)
    for name, g, w in zip(("albedo", "metallic", "roughness"), got[:3], want[:3]):
        assert g.shape == w.shape == (64, 64, 3 if name == "albedo" else 1), name
        assert np.isfinite(g).all() and g.min() >= 0 and g.max() <= 1, name
        np.testing.assert_allclose(g, w, atol=TEXTURE_ATOL, err_msg=name)
    for g, w in zip(got[3], want[3]):
        np.testing.assert_array_equal(g, w)
