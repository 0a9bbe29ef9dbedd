"""Training support of the port against nero_tpu: the warm-up-cosine
schedule, torch Adam driven by it against optax.adam, and the loss registry."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nero_tpu.train.losses import compute_losses as jax_losses
from nero_tpu.train.lr import warm_up_cos_schedule as jax_schedule
from nero_tpu_torch.train.losses import compute_losses, total_loss
from nero_tpu_torch.train.lr import warm_up_cos_schedule

# one intra-op thread: the suite runs several worker processes side by side
torch.set_num_threads(1)

LR_CFG = {"end_warm": 3, "end_iter": 12, "lr": 1e-2}


@pytest.mark.parametrize("step", [0, 1, 3, 5, 11, 12, 40])
def test_schedule_matches(step):
    np.testing.assert_allclose(warm_up_cos_schedule(LR_CFG)(step),
                               float(jax_schedule(LR_CFG)(step)), rtol=1e-6)


def test_adam_with_schedule_matches_optax():
    """LambdaLR stepping after each update gives step s the rate lr(s), as
    optax's schedule count does (f32, 10 steps of a quadratic)."""
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal(16).astype(np.float32)
    target = rng.standard_normal(16).astype(np.float32)

    sched = jax_schedule(LR_CFG)
    opt = optax.adam(learning_rate=sched)
    xj, state = jnp.asarray(x0), None
    state = opt.init(xj)
    grad_fn = jax.grad(lambda x: jnp.sum((x - target) ** 4))
    for _ in range(10):
        upd, state = opt.update(grad_fn(xj), state, xj)
        xj = optax.apply_updates(xj, upd)

    s = warm_up_cos_schedule(LR_CFG)
    xt = torch.tensor(x0, requires_grad=True)
    topt = torch.optim.Adam([xt], lr=s.base_lr)
    sch = torch.optim.lr_scheduler.LambdaLR(topt, lambda i: s(i) / s.base_lr)
    for _ in range(10):
        topt.zero_grad()
        torch.sum((xt - torch.from_numpy(target)) ** 4).backward()
        topt.step()
        sch.step()
    np.testing.assert_allclose(xt.detach().numpy(), np.asarray(xj), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("step", [0, 500, 1500])
def test_losses_match(step):
    rng = np.random.default_rng(step)
    out = {"loss_rgb": rng.uniform(0, 1, 64).astype(np.float32),
           "gradient_error": np.asarray([0.3], np.float32), "std": np.asarray([0.2], np.float32),
           "sdf_pts_norm": rng.uniform(0, 1.3, 256).astype(np.float32),
           "sdf_vals": rng.uniform(-0.3, 0.3, 256).astype(np.float32),
           "loss_occ": np.asarray([0.05], np.float32)}
    names = ["nerf_render", "eikonal", "std", "init_sdf_reg", "occ"]
    cfg = {"eikonal_weight": 0.1}
    ref = jax_losses(names, {k: jnp.asarray(v) for k, v in out.items()}, None, step, cfg)
    got = compute_losses(names, {k: torch.from_numpy(v) for k, v in out.items()}, None, step, cfg)
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    total = sum(float(jnp.mean(v)) for k, v in ref.items() if k.startswith("loss"))
    np.testing.assert_allclose(float(total_loss(got)), total, rtol=1e-5)
