"""Ray data parallelism of the port (parallel/mesh.py) on the CPU: gloo
ranks in spawned processes (tests/torch_parallel_common.py) against one
process, and against nero_tpu's step over a 2-device data mesh.

Bars, nero_tpu's of tests/test_parallel.py (f32, `bf16_hidden: false`):
every log value rtol 2e-3 / atol 1e-5, parameters after one Adam step
2e-4. The ranks sum in another order than one process, so the bars are not
bit bars; a rank that drops the all-reduce, draws its own rows or sizes the
occlusion loss from its own rows is off by orders of magnitude more (the
card's gate in chip_smoke.py phase 10 shows by how much). Against nero_tpu:
the loss rtol 1e-4 and each gradient leaf, normalised by its max or by 1e-2
of the largest gradient, atol 1e-3 (tests/test_torch_shape_e2e.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_common as C
from nero_tpu.ops.fg_lut import get_fg_lut as jax_fg_lut
from nero_tpu.parallel.mesh import constrain_rays, make_data_mesh
from nero_tpu.render import shape as J
from nero_tpu.train.losses import compute_losses as jax_compute_losses, total_loss as jax_total
from nero_tpu_torch.fields.mc_shading import _compaction
from nero_tpu_torch.geometry.proc_mesh import proc_mesh
from nero_tpu_torch.models.material import NeROMaterialModel
from nero_tpu_torch.models.shape import NeROShapeModel
from nero_tpu_torch.parallel import mesh as M
from test_torch_shape_e2e import PARITY_CFG, TINY_CFG, _parity_rays

torch.set_num_threads(1)

DP_CFG = {**TINY_CFG, "bf16_hidden": False}
OCC_STEP = 6   # past TINY_CFG's occ_loss_step: the occlusion loss and its kpr count


def _one_process(cfg, step):
    model = NeROShapeModel(dict(cfg), training=True, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    log = model.train_step(opt, step)
    return C._numpy(log), C._grads(model.params), C._params(model.params)


def _assert_dp_parity(ref, got, name):
    log1, _, p1 = ref
    log_o, _, p_o = got
    assert set(log_o) == set(log1)
    for k in log1:
        np.testing.assert_allclose(log_o[k], log1[k], rtol=2e-3, atol=1e-5, err_msg=f"{name}:{k}")
    worst = max(float(np.max(np.abs(p1[k] - p_o[k]))) for k in p1)
    assert worst < 2e-4, (name, worst)


@pytest.mark.parametrize("world,n_slices", [(2, 1), (4, 2)], ids=["data2", "slice2xdata2"])
def test_stage1_ranks_match_one_process(world, n_slices, tmp_path):
    """One step in the occlusion phase; every rank ends with the same
    parameters (the all-reduce) and the one process's log."""
    ref = _one_process(DP_CFG, OCC_STEP)
    assert ref[0]["loss_occ"] > 0.0
    ranks = C.run_ranks("shape_step", world, tmp_path, DP_CFG, OCC_STEP, n_slices)
    for r, got in enumerate(ranks):
        _assert_dp_parity(ref, got, f"rank{r}")
        assert all(np.array_equal(got[2][k], ranks[0][2][k]) for k in got[2])


@pytest.fixture(scope="module")
def sphere_mesh():
    return proc_mesh("sphere", grid=48, lo=-1.0, hi=1.0)


def _material_cfg(mesh):
    """The tiny Stage-II config of tests/test_torch_material_e2e.py on the
    exact device tracer, with both compactions at 5 % of the 1,536 sample
    directions (K = 128): the sphere's misses overflow the outer capacity."""
    return {"name": "dp_mat", "network": "material", "database_name": "proc/sphere/32_6",
            "train_ray_num": 32, "test_ray_num": 128, "mesh": mesh, "tracer": "bvh",
            "shader_cfg": {"diffuse_sample_num": 32, "specular_sample_num": 16,
                           "human_lights": False, "outer_light_version": "direction",
                           "bf16_hidden": False, "inner_compact_frac": 0.05,
                           "outer_compact_frac": 0.05},
            "loss": ["nerf_render", "mat_reg"], "val_metric": ["mat_render"],
            "key_metric_name": "psnr"}


def test_stage2_ranks_match_one_process_with_compaction_overflow(sphere_mesh, tmp_path):
    cfg = _material_cfg(sphere_mesh)
    model = NeROMaterialModel(dict(cfg), training=True, device="cpu")
    mc = model.mcfg
    assert mc.inner_compact_frac == 0.05 and mc.outer_compact_frac == 0.05
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    seen = []

    def compaction(mask_flat, frac, shard=None):
        out = _compaction(mask_flat, frac, shard)
        seen.append((int(mask_flat.sum()), out[0].numel()))
        return out

    import nero_tpu_torch.fields.mc_shading as MC
    mp = pytest.MonkeyPatch()
    mp.setattr(MC, "_compaction", compaction)
    try:
        ref = (C._numpy(model.train_step(opt, 0)), None, C._params(model.params))
    finally:
        mp.undo()
    # outer (misses) then inner (hits), K = 128 each: the misses overflow it
    assert [k for _, k in seen] == [128, 128] and seen[0][0] > 128, seen
    for r, got in enumerate(C.run_ranks("material_step", 2, tmp_path, cfg, 0)):
        _assert_dp_parity(ref, got, f"rank{r}")


@pytest.mark.parametrize("frac", [0.05, 0.3], ids=["overflow", "fits"])
def test_compaction_keeps_the_first_k_of_the_global_batch(frac, tmp_path):
    """Each rank keeps its selected entries whose global index is under K =
    ceil-to-128(frac x the global entries), as one process does."""
    rng = np.random.default_rng(3)
    mask = rng.uniform(size=(16, 48)) < 0.6
    src, to = _compaction(torch.from_numpy(mask.reshape(-1)), frac)
    n = mask.size
    kept = set(to.numpy()[to.numpy() < n].tolist())
    assert len(kept) == min(src.numel(), int(mask.sum()))
    got = set()
    for src_r, to_r in C.run_ranks("compaction", 2, tmp_path, mask, frac):
        valid = to_r >= 0
        assert np.array_equal(src_r[valid], to_r[valid])
        got |= set(to_r[valid].tolist())
    assert got == kept


def test_init_sdf_reg_reduces_before_its_thresholds(tmp_path):
    """The sphere prior's masked sums and counts are global before its
    thresholds and divisions: 2 ranks give one process's values, where the
    ranks' own means would not."""
    from nero_tpu_torch.train.losses import init_sdf_reg_loss
    rng = np.random.default_rng(5)
    norm = rng.uniform(0.2, 1.3, (8, 24)).astype(np.float32)
    norm[:4] *= 0.05                       # the small-norm points on rank 0 alone
    sdf = rng.uniform(-0.3, 0.3, (8, 24)).astype(np.float32)
    data = {"sdf_pts_norm": torch.from_numpy(norm.reshape(-1)),
            "sdf_vals": torch.from_numpy(sdf.reshape(-1))}
    want = {k: float(v) for k, v in init_sdf_reg_loss(data, None, 10, {}).items()}
    assert want["loss_sdf_small"] > 0 and want["loss_sdf_large"] > 0
    got = C.run_ranks("sdf_reg", 2, tmp_path, norm, sdf, 10)
    for g in got:
        for k in want:
            np.testing.assert_allclose(g[k], want[k], rtol=1e-6, err_msg=k)
    # rank 1's own mean would differ: it has no small-norm point
    half = {k: v[v.numel() // 2:] for k, v in data.items()}
    assert float(init_sdf_reg_loss(half, None, 10, {})["loss_sdf_small"]) == 0.0


def test_mesh_layouts_and_rows(tmp_path):
    """Axis names, layouts, the rows of each rank and the scene map."""
    assert (M.DATA_AXIS, M.SCENE_AXIS, M.SLICE_AXIS) == ("data", "scene", "slice")
    out = C.run_ranks("layouts", 4, tmp_path)
    for r, o in enumerate(out):
        assert o["data"] == (r, 4, {"data": 4}) and o["slices"] == (r, 4, {"slice": 2, "data": 2})
        assert o["rows"] == (r * 8, r * 8 + 8)
        assert o["scene"] == (r // 2, r % 2, {"scene_of_rank": {0: 0, 1: 0, 2: 1, 3: 1}})
        assert o["bad_slices"] and o["bad_rows"]


def test_init_from_env_without_a_launcher(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert M.init_from_env("cpu") is None
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert M.init_from_env("cpu") is None
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# against nero_tpu's step over a 2-device data mesh
# ---------------------------------------------------------------------------


def test_two_ranks_match_nero_tpu_sharded_loss_and_grads(tmp_path):
    """The port's 2-rank loss and all-reduced gradients on fixed rays
    (perturbation off) against nero_tpu's value_and_grad of the same loss
    over make_data_mesh(jax.devices()[:2]) with constrain_rays, at a step
    before the occlusion phase and one in it."""
    cfg = dict(PARITY_CFG)
    scfg_j = J.shape_config_from_dict(dict(cfg))
    params_j = jax.tree_util.tree_map(np.asarray, J.init_shape_params(jax.random.PRNGKey(0),
                                                                      scfg_j))
    rays = _parity_rays(NeROShapeModel(dict(cfg), training=True, device="cpu"))
    mesh = make_data_mesh(jax.devices()[:2])
    j = constrain_rays({k: jnp.asarray(v) for k, v in rays.items()}, mesh)

    def loss_j(p, step):
        out = J.render(p, scfg_j, jnp.asarray(jax_fg_lut()), j["rays_o"], j["rays_d"],
                       j["near"], j["far"], j["human_poses"], step, key=jax.random.PRNGKey(0),
                       is_train=True, perturb_overwrite=0.0)
        out["loss_rgb"] = J.compute_rgb_loss(out["ray_rgb"], j["rgb"], "charbonier")
        return jax_total(jax_compute_losses(cfg["loss"], out, None, step, cfg))

    vg = jax.jit(jax.value_and_grad(loss_j))
    p_j = jax.tree_util.tree_map(jnp.asarray, params_j)
    for step in (3, OCC_STEP):
        val_j, g_j = vg(p_j, jnp.asarray(step))
        got = C.run_ranks("shape_loss_and_grads", 2, tmp_path, cfg, rays, step, params_j)
        from nero_tpu_torch.core.convert import tree_items
        grads_j = dict(tree_items(jax.tree_util.tree_map(np.asarray, g_j)))
        floor = 1e-2 * max(np.abs(a).max() for a in grads_j.values())
        for loss_t, grads_t in got:
            np.testing.assert_allclose(loss_t, float(val_j), rtol=1e-4)
            assert set(grads_t) == set(grads_j)
            for k, a in grads_j.items():
                scale = max(np.abs(a).max(), floor)
                np.testing.assert_allclose(grads_t[k] / scale, a / scale, atol=1e-3,
                                           err_msg=f"step {step}: {k}")


def test_run_training_under_a_launcher(tmp_path):
    """run_training under torchrun's variables with WORLD_SIZE 2: both ranks
    train on one gloo group, rank 0 alone validates and writes the log and
    the checkpoint, the others wait at its barriers, every rank logs mfu."""
    import yaml
    cfg = {**DP_CFG, "val_metric": ["shape_render"], "total_step": 3, "train_log_step": 1,
           "val_interval": 2, "save_interval": 2, "model_root": str(tmp_path / "model"),
           "vis_dir": str(tmp_path / "vis"), "lr_cfg": {"end_warm": 1, "lr": 1e-3}}
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    out = C.run_ranks("run_training", 2, tmp_path, str(path), launcher_env=True)
    (steps0, val0, main0, size0, mfu0), (steps1, val1, main1, size1, mfu1) = out
    assert steps0 == steps1 == [0, 1, 2] and size0 == size1 == 2
    assert main0 and not main1 and val0 and not val1
    assert mfu0[1:] == [True, True] and mfu1[1:] == [True, True]
    model_dir = tmp_path / "model" / "test_tiny"
    assert (model_dir / "model.npz").exists()
    assert (model_dir / "train.txt").read_text().count("train step") == 3
