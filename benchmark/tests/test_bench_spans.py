"""The metrics that read the program's spans: each reads its spans' host ms
a step from the program's summary, and none reads anything (None) without
a recorded step, without its span, or from a program that has no spans."""
from __future__ import annotations

import sys

import pytest

from benchmark.harness import catalog

SPAN_METRICS = {"step.forward_host_ms": 12.0, "step.backward_host_ms": 20.0,
                "step.optimizer_host_ms": 3.0, "render.sampler_host_ms": 5.0,
                "render.occ_host_ms": 7.0, "kernels.wrapper_host_ms": 9.0}


def _summary(steps=2):
    # inclusive seconds over `steps` steps: twice the ms a step above, in s
    rows = {"nero.step": 0.1, "nero.step.forward": 0.024, "nero.step.backward": 0.040,
            "nero.step.optimizer": 0.006, "nero.render.sampler": 0.010,
            "nero.render.occ": 0.014, "nero.kernel.sdf_grad.fwd": 0.004,
            "nero.kernel.sdf_grad.bwd": 0.008, "nero.kernel.shader.bwd": 0.006}
    return {"steps": steps, "spans": {k: {"calls": steps, "inclusive_s": v, "self_s": v}
                                      for k, v in rows.items()}}


@pytest.fixture
def metrics():
    found = catalog.metrics()
    assert set(SPAN_METRICS) <= set(found)
    return {k: found[k] for k in SPAN_METRICS}


@pytest.fixture
def program(monkeypatch):
    from nero_tpu_torch.core import trace

    def use(summary):
        monkeypatch.setattr(trace, "summary", lambda: summary)
    return use


def test_each_metric_reads_its_spans(metrics, program):
    program(_summary())
    for name, mod in metrics.items():
        assert mod.SOURCE == "program_span" and mod.UNIT == "ms", name
        assert mod.read({}) == pytest.approx(SPAN_METRICS[name]), name


def test_no_step_no_span_no_reading(metrics, program):
    program(_summary(steps=0))
    assert all(mod.read({}) is None for mod in metrics.values())
    program({"steps": 3, "spans": {"nero.step": {"calls": 3, "inclusive_s": 0.3,
                                                 "self_s": 0.3}}})
    assert all(mod.read({}) is None for mod in metrics.values())


def test_a_program_without_spans_reads_nothing(metrics, monkeypatch):
    monkeypatch.setitem(sys.modules, "nero_tpu_torch.core.trace", None)
    assert all(mod.read({}) is None for mod in metrics.values())
