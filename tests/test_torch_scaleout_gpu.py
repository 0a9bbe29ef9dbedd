"""Card tests of slice 20 (`python3 -m pytest tests/test_torch_scaleout_gpu.py
-m gpu` on the H100; skipped without CUDA): each kernel's FLOP tally after
a Stage-I step is its launches x flops(...) at the step's shapes, and a
one-rank NCCL group steps as no group does, to the bit. No JAX here."""
import os

import pytest
import torch

from nero_tpu_torch.core.mfu import count_flops
from nero_tpu_torch.models.shape import NeROShapeModel
from nero_tpu_torch.ops import sdf_grad as G, shader as Sh

# the Stage-I widths (8 x 256 SDF, the whole-shader kernel) at few rays and samples
CFG = {"name": "gpu_tiny", "network": "shape", "database_name": "proc/sphere/32_6",
       "n_samples": 16, "n_importance": 16, "up_sample_steps": 2, "n_bg_samples": 4,
       "train_ray_num": 64, "occ_loss_step": 5, "occ_loss_max_pn": 128}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_tallies_are_launches_times_flops():
    dev = _cuda()
    model = NeROShapeModel(dict(CFG), device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    _, b = count_flops(model.train_step, opt, 0)
    rows = CFG["train_ray_num"] * (CFG["n_samples"] + CFG["n_importance"])
    n_pad = -(-rows // G.TILE) * G.TILE
    sh = model.scfg.shader
    assert b["launches_by_name"] == {"sdf_grad_fwd": 1, "sdf_grad_bwd": 1, "shader_fwd": 1,
                                     "shader_bwd": 1}
    assert b["kernels_by_name"] == {"sdf_grad_fwd": G.flops(n_pad),
                                    "sdf_grad_bwd": G.flops(n_pad, backward=True),
                                    "shader_fwd": Sh.flops(rows, sh),
                                    "shader_bwd": Sh.flops(rows, sh, backward=True)}
    assert b["unknown"] == 0 and b["library"] > 0


@pytest.mark.gpu
def test_one_nccl_rank_steps_as_no_group(tmp_path):
    import torch.distributed as dist
    from nero_tpu_torch.parallel.mesh import make_data_group

    dev = _cuda()

    def run(group):
        model = NeROShapeModel(dict(CFG), device=dev, group=group)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3, fused=True)
        logs = [{k: float(v) for k, v in model.train_step(opt, i).items()}
                for i in (0, 1, CFG["occ_loss_step"])]
        return logs, [p.detach().clone() for p in model.parameters()]

    alone = run(None)
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp_path, 'init')}",
                            rank=0, world_size=1)
    try:
        grouped = run(make_data_group())
    finally:
        dist.destroy_process_group()
    assert grouped[0] == alone[0]
    assert all(torch.equal(a, b) for a, b in zip(alone[1], grouped[1]))
