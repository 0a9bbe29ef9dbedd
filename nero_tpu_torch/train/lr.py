"""Learning-rate schedules (counterpart of nero_tpu/train/lr.py).

`warm_up_cos`: linear warm-up to `lr`, then cosine decay to 0.05 lr. The
trainer drives `torch.optim.Adam` with it through a LambdaLR of
`schedule(step) / lr`, so step s updates with lr(s), exactly as
`optax.adam(learning_rate=schedule)` does (same betas 0.9/0.999, eps 1e-8,
bias correction; optax adds eps outside the square root, as torch does).
"""
from __future__ import annotations

import math


def warm_up_cos_schedule(cfg: dict):
    c = {"end_warm": 5000, "end_iter": 300000, "lr": 5e-4, **cfg}
    warm, end, lr = c["end_warm"], c["end_iter"], c["lr"]
    alpha = 0.05

    def schedule(step: int) -> float:
        if step < warm:
            return lr * step / warm
        progress = min(max((step - warm) / (end - warm), 0.0), 1.0)
        return lr * ((math.cos(math.pi * progress) + 1.0) * 0.5 * (1 - alpha) + alpha)

    schedule.base_lr = lr
    return schedule


name2lr_schedule = {"warm_up_cos": warm_up_cos_schedule}
