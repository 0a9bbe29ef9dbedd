"""Checkpoints in both directions on the CPU: nero_tpu's `Trainer` writes a
tiny Stage-I `model.npz` that the port's `Trainer` resumes, the port writes
one that nero_tpu's `load_checkpoint` reads back with its templates, a
resumed run repeats the unbroken one, and a port checkpoint of the older
layout (parameters in the `.npz`, the optimizer in a `torch.save` file
beside it) still resumes.

Tolerances: parameters, Adam moments and counts are copies, so equal to the
bit; a validation view rendered by both packages from the same parameters
agrees to 1e-5 (f32 sums in another order); the port against itself is
exact on the CPU."""
import os

import jax
import numpy as np
import optax
import pytest
import torch

from nero_tpu.core import checkpoint as JC
from nero_tpu.train.lr import name2lr_schedule as jax_schedules
from nero_tpu.train.trainer import Trainer as JaxTrainer
from nero_tpu_torch.core.checkpoint import save_checkpoint
from nero_tpu_torch.core.convert import tree_items
from nero_tpu_torch.train.trainer import Trainer

# one intra-op thread: the suite runs several worker processes side by side
torch.set_num_threads(1)

CFG = {
    "name": "ckpt", "network": "shape", "database_name": "proc/sphere/32_6",
    "n_samples": 16, "n_importance": 8, "up_sample_steps": 2, "n_bg_samples": 4,
    "sdf_n_layers": 4, "train_ray_num": 32, "test_ray_num": 512, "occ_loss_step": 5,
    "occ_loss_max_pn": 64, "anneal_end": 100, "test_downsample_ratio": True,
    "downsample_ratio": 0.25, "loss": ["nerf_render", "eikonal", "std", "init_sdf_reg", "occ"],
    "val_metric": ["shape_render"], "key_metric_name": "psnr", "eikonal_weight": 0.1,
    "lr_cfg": {"end_warm": 2, "end_iter": 10, "lr": 1e-3}, "train_log_step": 1,
    "val_interval": 100, "save_interval": 100,
}


def _cfg(tmp_path, total_step, **over):
    return {**CFG, "model_root": str(tmp_path / "model"), "vis_dir": str(tmp_path / "vis"),
            "total_step": total_step, **over}


def _npz(path) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _port_state(trainer) -> dict:
    """{'P|k', 'O|0|mu|k', 'O|0|nu|k', 'O|0|count'} of a port trainer, as numpy."""
    out = {}
    for k, leaf in tree_items(trainer.model.params):
        st = trainer.optimizer.state[leaf]
        out["P|" + k] = leaf.detach().numpy()
        out["O|0|mu|" + k] = st["exp_avg"].numpy()
        out["O|0|nu|" + k] = st["exp_avg_sq"].numpy()
        out["O|0|count"] = int(st["step"])
    return out


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """nero_tpu's Trainer: 3 steps, then its checkpoint (and validation)."""
    tmp = tmp_path_factory.mktemp("jax")
    trainer = JaxTrainer(_cfg(tmp, 3))
    trainer.run()
    return tmp, trainer


def test_port_resumes_a_nero_tpu_checkpoint(jax_checkpoint):
    tmp, jtrainer = jax_checkpoint
    stored = _npz(os.path.join(tmp, "model", "ckpt", "model.npz"))
    assert int(stored["__step__"]) == 3 and int(stored["O|0|count"]) == 3
    trainer = Trainer(_cfg(tmp, 3), device="cpu")
    trainer.setup()
    best, step = trainer.resume()
    assert step == 3 and best == pytest.approx(float(stored["__best_para__"]))
    assert trainer.scheduler.last_epoch == int(stored["O|1|count"]) == 3
    assert trainer.optimizer.param_groups[0]["lr"] == pytest.approx(
        trainer.lr_schedule(3), rel=1e-7)
    port = _port_state(trainer)
    for k, v in port.items():
        assert np.array_equal(v, stored[k]), k
    assert {k for k in stored if k.startswith(("P|", "O|0|"))} == set(port)
    # one validation view from the same parameters in both packages
    with torch.no_grad():
        out_t = trainer.model.test_step(trainer.model.params, 0, step)
    out_j = jtrainer.model.test_step(jtrainer.model.params, 0, step)
    for k in ("ray_rgb", "depth", "normal"):
        np.testing.assert_allclose(out_t[k], np.asarray(out_j[k]), rtol=0, atol=1e-5,
                                   err_msg=k)


def test_nero_tpu_reads_a_port_checkpoint(tmp_path, jax_checkpoint):
    """The port writes P| and O| in nero_tpu's layout: nero_tpu's
    load_checkpoint fills its templates (its model's parameters and
    optax.adam(schedule)'s state) from them."""
    _, jtrainer = jax_checkpoint
    trainer = Trainer(_cfg(tmp_path, 3), device="cpu")
    trainer.run()
    port = _port_state(trainer)
    lr_cfg = dict(CFG["lr_cfg"], end_iter=3)
    template = optax.adam(jax_schedules["warm_up_cos"](lr_cfg)).init(jtrainer.model.params)
    step, _, params, opt_state = JC.load_checkpoint(trainer.ckpt_fn, jtrainer.model.params,
                                                    template)
    assert step == 3
    flat_p = JC._flatten(params)
    flat_o = JC._flatten(opt_state)
    assert set(flat_p) == {k[2:] for k in port if k.startswith("P|")}
    for k, v in flat_p.items():
        assert np.array_equal(v, port["P|" + k]), k
    assert int(flat_o["0|count"]) == port["O|0|count"] == 3 and int(flat_o["1|count"]) == 3
    for k, v in flat_o.items():
        if k.startswith(("0|mu|", "0|nu|")):
            assert np.array_equal(v, port["O|" + k]), k


def test_resumed_run_repeats_the_unbroken_one(tmp_path):
    """6 steps straight, and 3 + resume + 3 from the checkpoint: the same
    losses and parameters, to the bit."""
    straight = Trainer(_cfg(tmp_path / "a", 6), device="cpu")
    straight.run()
    first = Trainer(_cfg(tmp_path / "b", 3), device="cpu")
    first.run()
    second = Trainer(_cfg(tmp_path / "b", 6), device="cpu")
    second.run()
    assert [h["step"] for h in second.train_history] == [3, 4, 5]
    losses = lambda hist: [h["loss_total"] for h in hist]
    assert losses(first.train_history) + losses(second.train_history) == \
        losses(straight.train_history)
    for (k, a), (_, b) in zip(tree_items(straight.model.params),
                              tree_items(second.model.params)):
        assert torch.equal(a, b), k


def test_older_port_checkpoint_still_resumes(tmp_path):
    """A checkpoint of the layout before nero_tpu's O| keys: the .npz holds
    __step__, __best_para__ and P| only, the optimizer's state_dict is a
    torch.save file beside it."""
    src = Trainer(_cfg(tmp_path / "old", 3), device="cpu")
    src.run()
    path = src.ckpt_fn
    stored = _npz(path)
    np.savez(path, **{k: v for k, v in stored.items() if not k.startswith(("O|", "R|"))})
    torch.save(src.optimizer.state_dict(), path + ".opt")
    resumed = Trainer(_cfg(tmp_path / "old", 3), device="cpu")
    resumed.setup()
    _, step = resumed.resume()
    assert step == 3 and resumed.scheduler.last_epoch == 3
    for k, v in _port_state(resumed).items():
        assert np.array_equal(v, _port_state(src)[k]), k


def test_checkpoint_layout(tmp_path):
    """The keys and dtypes of a port checkpoint: nero_tpu's, plus R|gen."""
    trainer = Trainer(_cfg(tmp_path, 2), device="cpu")
    trainer.setup()
    trainer.train_step(0)
    path = str(tmp_path / "x.npz")
    trainer.save(path, 1, 0.5)
    stored = _npz(path)
    leaves = [k for k, _ in tree_items(trainer.model.params)]
    assert set(stored) == ({"__step__", "__best_para__", "O|0|count", "O|1|count", "R|gen"}
                           | {p + k for k in leaves for p in ("P|", "O|0|mu|", "O|0|nu|")})
    assert stored["O|0|count"].dtype == np.int32 and stored["O|1|count"].dtype == np.int32
    assert stored["__step__"].dtype == np.int64 and stored["R|gen"].dtype == np.uint8
    sgd = torch.optim.SGD(trainer.model.parameters(), lr=0.1)
    save_checkpoint(path, 1, 0.0, trainer.model.params, sgd, 1)
    assert not any(k.startswith("O|0|") for k in _npz(path)) and "O|1|count" in _npz(path)
