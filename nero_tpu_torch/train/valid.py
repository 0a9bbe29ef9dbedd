"""Validation evaluator (counterpart of nero_tpu/train/valid.py): render the
held-out views, aggregate losses + metrics, return the key metric."""
from __future__ import annotations

import functools
import time

import numpy as np

from nero_tpu_torch.train.metrics import name2key_metrics


class ValidationEvaluator:
    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.key_metric_name = cfg["key_metric_name"]
        self.key_metric = name2key_metrics[self.key_metric_name]

    def __call__(self, model, params, losses, metrics, val_indices, step, model_name,
                 val_set_name=None, vis_dir="data/train_vis"):
        if val_set_name is not None:
            model_name = f"{model_name}-{val_set_name}"
        eval_results = {}
        begin = time.time()
        for data_i, index in enumerate(val_indices):
            outputs = model.test_step(params, index, step)
            for loss_fn in losses:
                for k, v in loss_fn(outputs, None, step, self.cfg).items():
                    eval_results.setdefault(k, []).append(np.atleast_1d(np.asarray(v)))
            for metric_fn in metrics:
                fn = functools.partial(metric_fn, vis_dir=vis_dir)
                for k, v in fn(outputs, None, step, data_index=data_i,
                               model_name=model_name).items():
                    eval_results.setdefault(k, []).append(np.atleast_1d(np.asarray(v)))
        eval_results = {k: np.concatenate(v, axis=0) for k, v in eval_results.items()}
        key_metric_val = self.key_metric(eval_results)
        eval_results[self.key_metric_name] = key_metric_val
        print(f"eval cost {time.time() - begin:.1f} s")
        return eval_results, key_metric_val
