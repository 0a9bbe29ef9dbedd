"""End-to-end Stage-I smoke test of the port on the procedural scene (CPU,
tiny shapes): the mirror of tests/test_shape_e2e.py."""
import numpy as np
import pytest
import torch

from nero_tpu_torch.models.shape import NeROShapeModel
from nero_tpu_torch.train.trainer import Trainer

# one intra-op thread: the suite runs several worker processes side by side
torch.set_num_threads(1)

TINY_CFG = {
    "name": "test_tiny", "network": "shape", "database_name": "proc/sphere/32_6",
    "n_samples": 16, "n_importance": 8, "up_sample_steps": 2, "n_bg_samples": 4,
    "train_ray_num": 32, "test_ray_num": 64, "occ_loss_step": 5, "occ_loss_max_pn": 64,
    "anneal_end": 100, "test_downsample_ratio": True, "downsample_ratio": 0.5,
    "loss": ["nerf_render", "eikonal", "std", "init_sdf_reg", "occ"],
    "eikonal_weight": 0.1, "key_metric_name": "psnr",
}


@pytest.fixture(scope="module")
def model():
    m = NeROShapeModel(dict(TINY_CFG), training=True, device="cpu")
    opt = torch.optim.Adam(m.parameters(), lr=1e-3)
    losses = [float(m.train_step(opt, i)["loss_rgb"]) for i in range(8)]
    m.losses, m.opt = losses, opt
    return m


def test_train_step_runs_and_improves(model):
    assert all(np.isfinite(model.losses))
    assert np.mean(model.losses[-3:]) < np.mean(model.losses[:3]), model.losses


def test_log_contains_expected_keys(model):
    log = model.train_step(model.opt, 10)
    for k in ["loss_rgb", "loss_eikonal", "std", "loss_occ", "loss_sdf_small",
              "loss_sdf_large", "loss_total"]:
        assert k in log, f"missing {k}"
        assert np.isfinite(float(log[k])), k


def test_test_step_outputs(model):
    outputs = model.test_step(model.params, 0, step=10)
    h, w = outputs["ray_rgb"].shape[:2]
    assert outputs["gt_rgb"].shape == (h, w, 3)
    assert outputs["normal"].shape == (h, w, 3)
    assert outputs["depth"].shape == (h, w, 1)
    assert outputs["occ_prob_gt"].shape == (h, w, 1)
    for k in ["metallic", "roughness", "occ_prob"]:
        assert outputs[k].shape == (h, w, 1)
    assert np.isfinite(outputs["ray_rgb"]).all()


def test_nvs(model):
    pose = model.test_imgs_info["poses"][0]
    K = model.test_imgs_info["Ks"][0]
    img = model.nvs(model.params, pose, K, 16, 16, step=10)
    assert img.shape == (16, 16, 3)
    assert np.isfinite(img).all()


def test_trainer_runs_validates_and_resumes(tmp_path):
    cfg = {**TINY_CFG, "val_metric": ["shape_render"], "total_step": 3, "train_log_step": 1,
           "val_interval": 3, "save_interval": 2, "model_root": str(tmp_path),
           "vis_dir": str(tmp_path), "lr_cfg": {"end_warm": 1, "lr": 1e-3}}
    trainer = Trainer(dict(cfg), device="cpu")
    trainer.run()
    assert [h["step"] for h in trainer.train_history] == [0, 1, 2]
    assert np.isfinite(trainer.val_results["val-psnr"])
    assert (tmp_path / "test_tiny" / "model.npz").exists()
    resumed = Trainer({**cfg, "total_step": 4}, device="cpu")
    resumed.run()
    assert [h["step"] for h in resumed.train_history] == [3]


def test_entry_points_need_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        NeROShapeModel(dict(TINY_CFG), training=False)
