"""The algorithmic work counts: the closed forms against hand arithmetic,
below what the plain reference executes, and frozen in every workload."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import catalog
from benchmark.harness.weights import make_params
from benchmark.reference.fields import resolve_tree, sdf_with_grad
from benchmark.work import cell, peaks, sdf_grad, shader


def test_sdf_grad_by_hand():
    # layers (39, 256), (256, 256) x 2, (256, 217), (256, 256) x 4, (256, 257)
    fwd = 39 * 256 + 2 * 256 * 256 + 256 * 217 + 4 * 256 * 256 + 256 * 257
    sweep = fwd - 256 * 257
    backward = 2 * fwd - 2 * 39 * 256 + 2 * sweep
    assert sdf_grad.flops(1000) == 2.0 * 1000 * (fwd + sweep + backward) == 5_859_840_000.0
    assert sdf_grad.min_bytes(1000) == 4.0 * (1000 * 523 + 3 * (fwd + 7 * 256 + 217 + 257))


def test_shader_by_hand():
    heads = {"metallic": (259, 1, 256), "roughness": (259, 1, 256), "albedo": (259, 3, 256),
             "outer_light": (72, 3, 72), "inner_light": (123, 3, 72), "inner_weight": (90, 1, 0)}
    fwd = bwd = 0
    for name, (d_in, d_out, g_in) in heads.items():
        k = 2 if name == "outer_light" else 1
        body = d_in * 256 + 2 * 256 * 256 + 256 * d_out
        fwd += k * body
        bwd += k * (body + 2 * 256 * 256 + 256 * d_out + g_in * 256)
    assert (fwd, bwd) == (1_211_648, 2_384_896)
    assert shader.flops(1000, {}) == 2.0 * 1000 * (fwd + bwd)
    human = shader.macs_per_row({"human_light": True})
    body = 24 * 256 + 2 * 256 * 256 + 256 * 4
    assert human["forward"] == fwd + body
    assert human["backward"] == bwd + body + 2 * 256 * 256 + 256 * 4 + 24 * 256


def test_least_work_is_below_what_the_reference_executes():
    n = 64
    layers = resolve_tree(make_params(catalog.config("nero_shape_syn"), 0, "cpu")["sdf"])
    x = torch.rand(n, 3) - 0.5
    with FlopCounterMode(display=False) as counter:
        sdf, feats, grad = sdf_with_grad(layers, x, 6, "f32")
        (sdf.sum() + feats.sum() + grad.pow(2).sum()).backward()
    assert sdf_grad.flops(n) <= counter.get_total_flops() <= 1.2 * sdf_grad.flops(n)


def test_work_is_frozen_in_every_workload():
    for name in catalog.workload_names():
        w = catalog.workload(name)
        cfg = catalog.config(w["config"])
        assert {k: w["work"][k] for k in ("sdf_grad", "shader")} == cell.kernel_work(cfg, w)
        kernels = sum(v["flops"] for k, v in w["work"].items() if k != "step_flops")
        assert w["work"]["step_flops"] > kernels


def test_step_flops_count_runs_on_the_cpu():
    w = catalog.workload("shape_syn.occ")
    cfg = {**catalog.config(w["config"]), "train_ray_num": 8}
    assert cell.step_flops(cfg, w, device="cpu") > 0


def test_a_card_without_a_peak_has_no_share():
    assert peaks.least_seconds(1e12, 1e9, "some other card") is None
    assert peaks.least_seconds(989.4e12, 0.0, "NVIDIA H100 80GB HBM3") == 1.0
