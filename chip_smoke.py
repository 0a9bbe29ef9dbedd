#!/usr/bin/env python3
"""Smoke test of nero_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version, then trains Stage I on
`configs/shape/proc/{sphere,sphere_real,sphere_heads}.yaml` and Stage II on
`configs/material/proc/{bowl,bowl_fused}.yaml` at full width through the
kernels, takes a few steps through every other switch of both stages, runs
the chain Stage I -> mesh -> Chamfer -> Stage II -> materials, and the
capture path: a scene written as a COLMAP custom object, read through the
crop and raw caches by both stages and both pipeline tools, trains both
stages under each setting of the precision switches, resuming one run from
a checkpoint in nero_tpu's layout, and takes both stages through the ray
data-parallel path, two scenes in the multi-scene model's one step (B1,
B2, B6 and B8 launched once a step for all scenes) and its tool,
and every training configuration's FLOPs to an MFU.

    python3 chip_smoke.py

Phases (each raises on failure, so the run exits non-zero and prints no
result line):
  1. card name and power limit; build every kernel (one nvcc per source,
     all at once) and print the build seconds;
  2. the Stage-I kernel functions at N = 65,536 rows with full-width weights
     from a seed, against their plain versions, with the tolerances of the
     JAX kernel tests: SDF-with-gradient fwd/bwd; the whole-shader kernel
     fwd/bwd in its four variants (default, `sphere_direction`,
     `human_light`, both), at n = 1,001 and 0 too, each direction the same
     to the bit in two calls, its four kernels' ptxas (0 spill bytes); the
     predictor kernel fwd/bwd for each of the shader's seven head shapes
     (259 -> 1 ... 24 -> 4), at n = 1,001 and 0 too, its forward's output
     and its backward's dx, dW and dB to the bit in two calls, the
     backward's three parts timed apart, the four kernels' ptxas (0 spill
     bytes); the value-only SDF kernel at 131,072 points (the occlusion
     march's first pass) and 32,768 (the sampler's), equal to the bit to the
     SDF-with-gradient kernel's sdf there and at 3 x 1,001 points, its two
     tile sizes the same bits, 0 spill bytes, timed also at 8,192 (its three
     up-sample passes) and on both sides of its tile rule's threshold;
     then the light kernel (fwd/bwd; both heads, and the outer head alone
     with `sphere_direction`) at N = 393,216 rows, and at n = 1,001 and 0,
     its forward's outputs and its backward's dW / dB to the bit in two
     calls, the backward's two parts timed apart, its four kernels' ptxas
     (0 spill bytes); kernel and plain times
     from CUDA events; then B1 and B2 (`default`, `human_light`) with the
     scene axis, one launch each way for S = 2 and 4 scenes of 65,536 rows,
     B6 for S scenes of 131,072, 32,768 and 8,192 points and B8 for S
     scenes of 65,536 rows at each of the seven head shapes
     (`check_scene_kernels`): each scene's outputs and dW / db (B8: dx, dW,
     dB) equal to its
     one-scene launch to the bit, the batched wrapper's outputs and
     parameter gradients equal to the one-scene wrapper's, each scene within
     the one-scene rows' bars of the plain version, the launches timed
     beside S one-scene launches in turn, the bound S x one scene's;
  3. the mesh of the bowl scene from its analytic SDF (host iso-surfacer); a
     `std` and a `wide` field distilled from it on the card; for each, the
     sphere-march and uniform-march kernels against their plain versions on
     393,216 surface rays (found agreement >= 0.99, median |dt| < 1e-3), both
     marches also on 0 rays (empty outputs) and on the first 1,001 (the
     same bars), and the one-evaluation kernel on 393,216 and 1,001 points
     (atol 1e-3 to its plain version, 2e-2 to the f32 field) and on none; the
     three kernels' ptxas (0 spill bytes); the neural tracer (sphere march,
     uniform march, wide field) against the exact host BVH (clearing-ray hit
     agreement >= 0.98) and the device BVH traversal against the host's;
  4. `Trainer` on each of the three sphere configs with only total_step,
     val_interval, save_interval and the output dirs overridden, then one
     step past occ_loss_step; losses finite, held-out loss_rgb falling,
     validation run, every kernel's launch count as expected for the steps
     taken (`stage1_expect`), and the `sphere_heads.yaml` loss curve (per-head
     shader through the predictor kernel, no-gradient SDF values through the
     value-only kernel) beside `sphere.yaml`'s; then a few steps each, every
     launch count asserted, of `sphere_direction`, `sphere_direction` with
     `human_light`, `shade_top_k: 32` past occ_loss_step, `bg_on_inner`,
     `remat_shader`, and `human_light` through the whole-shader kernel, the
     per-head tensor ops and the per-head predictor kernel, with their step
     times side by side;
  5. `Trainer` on the bowl material config (mesh, steps, intervals and
     output dirs overridden), unfused and then fused (`bowl_fused.yaml`):
     losses finite, held-out loss_rgb falling, one validation view, one
     march launch per step and validation chunk and, fused, one forward of
     the light kernel per step and chunk and one backward per step;
  6. a few Stage-II steps each, every launch count asserted: the convex
     sphere scene with the human light and the sphere_direction outer light
     (inner compaction on), unfused and fused (the light kernel runs the
     outer head only); the uniform march; the wide field under both marches;
     `tracer: grid`, whose grid tracer is held against the exact host BVH;
  7. the chain a user runs after training (`chain`): `sphere.yaml` for 300
     steps, its mesh by `extract_mesh` at 512^3 (grid evaluation and host
     iso-surface timed apart), the same checkpoint's 64^3 grid on the card
     against the CPU (max |diff| <= 1e-4), `eval_synthetic_shape` on
     `proc/sphere/128_16`, the Chamfer distance to the denser cloud of
     `proc/sphere/256_24` and the vertices' mean |scene SDF| (finite, > 100
     vertices, median radius in (0.2, 0.9)), `bowl.yaml`'s Stage II for 5
     steps on that mesh through the neural tracer (finite losses), then
     `extract_materials` (finite, in [0, 1], one row per vertex) and
     `extract_materials_texture_map` at 1024^2 (the files written); both
     trainings' launches asserted and counted, extraction launching none;
  8. the capture data path (`capture`), under a temporary database root:
     PIL's 16-bit PNG round trip; (a) the `capture` scene exported as a
     custom object (`run_real_pipeline.export_scene`: 16 views at 300 px,
     a COLMAP sparse model, the object cloud), its parse + crop cache at
     256 and its raw cache; (b) `configs/custom/kettle_shape.yaml` on
     `custom/capture_sim/raw_300` as in phase 4 (B1 and B2's human_light
     variant, launches exact, held-out loss_rgb falling, one occ step);
     (c) `run_real_pipeline` (Stage I 300 steps through the crop cache,
     mesh at 128^3, Stage II 5 steps); (d) `configs/custom/kettle_material.
     yaml` for 5 steps on (c)'s mesh over the raw images; (e)
     `run_pipeline_demo --scene capture` with `tracer: neural`, `grid` and
     `bvh`. The reports hold the JAX tools' keys, every figure finite;
     every trainer's launches are asserted for the tracer its model chose
     (B3 once a step and a validation chunk with the neural tracer, nothing
     with the grid or the BVH), and each tool's total; every part's seconds
     are printed;
  9. the precision switches (`precision`): the three product modes of
     ops/mlp.py (bf16 operands with an f32 result, forward and backward,
     against the f64 product; TF32 set and restored); Stage I
     `sphere.yaml` for 30 steps each with (a) the keys unset (B1 + B2),
     (b) `sdf_grad_mode: rev`, (c) `fwd`, (d) `bf16_hidden: false` and (e)
     with `fwd` ((d) and (e) at `matmul_precision: highest`, f32
     throughout), each resolution and its exact launches checked, the
     held-out loss_rgb falling, the step-0 loss of (e) within 1e-4 and of
     (a)-(c) different from (d) but within 5e-4 of it; run (a) checkpoints
     at step 15 in nero_tpu's layout and a fresh Trainer resumes it, steps
     15-29 within 1e-5 of the unbroken run; Stage II `bowl.yaml` for 30
     steps at `matmul_precision` `highest`, `high` and unset (bf16 storage)
     and all-f32, launches exact, the held-out loss falling; against the
     all-f32 run, the colours of one fixed batch before training within
     3e-4, the held-out loss's fall within 1e-3 relative and its PSNR within
     0.5 dB; the bf16 storage, TF32 and the bf16 operands each move those
     colours; step medians, rays/s or points/s and the
     busy ms a step (profile_step.py's counting) with its share in library
     products printed beside the card's name and power limit;
 10. scale-out and MFU (`scaleout`): (a) `sphere.yaml` for 30 steps and
     `bowl.yaml` for 10 through Trainer.train_step without a group and on a
     one-rank NCCL group (global draws, a slice that is every row, the
     all-reduces): every log value and parameter equal to the bit, launches
     exact, both step medians; (b) two ranks on the one card over gloo, one
     step of `sphere.yaml` at occ_loss_step from the seed's parameters against
     one process: loss within 1e-5 relative, all-reduced gradients within
     1e-3 (`grad_err_normalised`), and outside a bar under each runtime
     patch (the all-reduce dropped, draws of the rank's own rows, kpr from
     the rank's own rows), every number printed; the step's median on the
     ranks and in one process; (c) two scenes of `sphere.yaml` for 20 steps
     through MultiSceneShapeModel's one step, each equal to the bit to the
     scene trained alone with seed 6033 + s, B1 and B2 launched once a step
     for both scenes (their `_scenes` counters at one scene's counts, the
     one-scene counters at 0); the step's host ms and device busy ms at 1, 2
     and 4 scenes; two scenes of `sphere_real.yaml` for 4 steps, launches
     exact; two scenes of `sphere_heads.yaml` for 8 steps with
     occ_loss_step at 5, each equal to the bit to the scene alone, B1, B6
     and B8 under their `_scenes` counters only (one scene's counts), and
     that step's host and busy ms at 1, 2 and 4 scenes; the background NeRF's weight-gradient product by torch.bmm
     against torch.mm scene by scene (reported: the step keeps the latter);
     then `train_multi_scene` for 4 steps unbroken and resumed at 2, equal
     to the bit, its exports loaded into NeROShapeModel; (d) the FLOPs of the first
     step of phases 4 and 5's five trainings (library, kernels, total),
     each kernel's tally equal to its launches x flops(...) at the main
     path's shapes, `expect_kernels` on each configuration's kernels, the
     step median and the logged mfu in (0, 1), with the card line;
 11. the other encodings that nero_tpu's kernels take (`encodings`; their
     kernel rows in phase 2, `check_encoding_kernels`): B1, B6 at other
     multires, B2 at other (ide_deg, light_pos_freq) up to (5, 64) (past one
     256-wide tile of light input from light_pos_freq 31 on: 0 spill bytes,
     `human_light`, both, and the scene axis at (5, 32)), B5 at other
     degrees, B3, B4 and B7 at pe 0, 3 and 7 with the NeuralTracer at pe 7
     against the exact BVH; `sphere_enc.yaml`, `bowl_enc.yaml`,
     `sphere_lpf32.yaml` trained with exact launches and their FLOPs.
The line before the result is a JSON object with every kernel's numbers;
the last line is {"ok": true, "device": {...}}. Of a kernel's times, `ms` is
the wrapper's whole call for the kernels behind an autograd function (shader,
predictor, lights) and the launch on packed weights for the others;
`launch_ms` and `wrapper_ms` give both readings where they differ. `--only
kernels` stops after phase 3 (for work on a kernel; no result line); `--only
capture` and `--only precision` build the kernels and run phase 8 or phase 9
alone, `--only scaleout` the five trainings of phases 4 and 5 and phase 10
(no result line).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PEAK_BF16 = 989e12     # H100 SXM dense bf16, FLOP/s (NVIDIA data sheet)
PEAK_BYTES = 3.35e12   # H100 SXM HBM3, bytes/s
N_ROWS = 65536         # the training lattice: 512 rays x 128 inner samples
N_OCC_MARCH = 131072   # the occlusion march's first pass: 2048 points x 64 samples
N_SAMPLER = 32768      # the proposal sampler's first pass: 512 rays x 64 samples
N_UPSAMPLE = 8192      # each of its three up-sample passes: 512 rays x 16 samples
N_MARCH_RAYS = 393216  # Stage II: 512 points x (512 diffuse + 256 specular) directions
STAGE1_STEPS = 30      # Stage I: sphere.yaml, sphere_real.yaml, sphere_heads.yaml
HEADS_HELD_OUT_TOL = 1e-3  # sphere_heads.yaml against sphere.yaml after STAGE1_STEPS steps
HEADS_CURVE_TOL = 1e-3     # and at every step of them (measured: 4e-6 and 6e-6)
UNFUSED_STEPS = 30     # Stage II, bowl.yaml (separate light ops)
FUSED_STEPS = 30       # Stage II, bowl_fused.yaml (the light kernel)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_split(setup, timed, iters: int = 5, warmup: int = 1) -> float:
    """Mean time of `timed(setup())`, excluding `setup` (e.g. a backward
    after its untimed forward)."""
    total = 0.0
    for i in range(warmup + iters):
        arg = setup()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        timed(arg)
        end.record()
        torch.cuda.synchronize()
        if i >= warmup:
            total += start.elapsed_time(end)
    return total / iters


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check(ok: bool, msg: str):
    if not ok:
        raise AssertionError(msg)


def leaves(tree):
    from nero_tpu_torch.core.convert import tree_leaves
    return tree_leaves(tree)


def grad_err_normalised(ga, gb) -> float:
    worst = 0.0
    for a, b in zip(ga, gb):
        scale = a.abs().max().item() + 1e-8
        worst = max(worst, ((a - b).abs().max() / scale).item())
    return worst


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def sdf_with_grad_f64(params, x, cfg):
    """The plain version's function in f64: (sdf, feats, grad) of the
    weight-norm SDF on points x, grad by double backprop (the port's plain
    version multiplies in f32 whatever its inputs)."""
    import torch.nn.functional as F

    from nero_tpu_torch.utils.encodings import positional_encode

    xg = x.detach().double().requires_grad_(True)
    inputs = positional_encode(xg * cfg.scale, cfg.multires)
    h = inputs
    for l, layer in enumerate(params):
        v = layer["v"]
        w = layer["g"] * v / torch.clamp(torch.linalg.norm(v, dim=0, keepdim=True), min=1e-12)
        if l == cfg.skip:
            h = torch.cat([h, inputs], -1) / math.sqrt(2.0)
        h = h @ w + layer["b"]
        if l < len(params) - 1:
            h = F.softplus(h, beta=cfg.beta)
    (grad,) = torch.autograd.grad(h[..., 0].sum(), xg, create_graph=True)
    return h[..., :1], h[..., 1:], grad


def sdf_f64_error(params, cfg, pts, cot) -> dict:
    """The plain version's own f32 error against its function in f64
    (`sdf_with_grad_f64`, weights and points cast): sdf, grad and the
    parameter gradients of check_sdf's loss, each as check_sdf measures the
    kernel's."""
    from nero_tpu_torch.core.convert import tree_map
    from nero_tpu_torch.ops import sdf_grad as K

    p64 = tree_map(lambda a: a.detach().double().requires_grad_(True), params)
    out32, out64 = K.sdf_with_grad_plain(params, pts, cfg), sdf_with_grad_f64(p64, pts, cfg)

    def loss(o):
        sdf, feats, grad = o
        eik = ((torch.linalg.norm(grad, dim=-1) - 1.0) ** 2).mean()
        return (sdf ** 2).mean() + 0.1 * eik + (feats * cot.to(feats.dtype)).mean()

    g32 = torch.autograd.grad(loss(out32), leaves(params))
    g64 = torch.autograd.grad(loss(out64), leaves(p64))
    return {"sdf": (out32[0].double() - out64[0]).abs().max().item(),
            "grad": (out32[2].double() - out64[2]).abs().max().item(),
            "param_grads": grad_err_normalised([g.double() for g in g64], g32)}


def check_sdf(n: int, dev, multires: int = 6, full: bool = True) -> list:
    """B1 against its plain version at `multires` (with live PE weights
    where it is not the shipped 6). `full`: also n = 1,001 and 0 rows, the
    backward's parts timed apart and the ptxas spill gate (the shipped
    build's)."""
    from nero_tpu_torch.fields.sdf import SDFConfig
    from nero_tpu_torch.ops import sdf_grad as K
    from nero_tpu_torch.ops.mlp import resolve_weight_norm

    from nero_tpu_torch.kernel_variants import sdf_params

    cfg = SDFConfig(multires=multires)
    params = sdf_params(cfg, dev)  # the PE's weights live away from multires 6
    tag = K.counter("", multires)
    rng = np.random.default_rng(1)
    pts = torch.as_tensor(rng.uniform(-0.7, 0.7, (n, 3)).astype(np.float32), device=dev)
    cot = torch.as_tensor(rng.standard_normal((n, 256)).astype(np.float32) * 0.1, device=dev)
    # the bars of row 1 (PERF.md section 6); at multires 20 the plain f32
    # version itself is off its f64 self by the top octave's rounding (sin of
    # 2^19 x), and the bars there are the larger of those and 2x that error
    bars = {"sdf": 5e-3, "grad": 2e-2, "param_grads": 2e-2}
    if multires > 10:
        own = sdf_f64_error(params, cfg, pts[:8192], cot[:8192])
        bars = {k: max(v, 2.0 * own[k]) for k, v in bars.items()}
        print(f"sdf_grad{tag}  the plain version's own f32-vs-f64 error: max|d sdf| "
              f"{own['sdf']:.3e}, max|d grad| {own['grad']:.3e}, param grads max|d|/max|g| "
              f"{own['param_grads']:.3e}; bars here: sdf {bars['sdf']:.3e} + 1e-2 rel, grad "
              f"{bars['grad']:.3e} + 5e-2 rel, param grads {bars['param_grads']:.3e}")

    with torch.no_grad():
        sdf_k, feats_k, grad_k = K.sdf_with_grad(params, pts, cfg)
        sdf_p, feats_p, grad_p = K.sdf_with_grad_plain(params, pts, cfg)
    e_sdf = (sdf_k - sdf_p).abs()
    e_grad = (grad_k - grad_p).abs()
    check(bool((e_sdf <= bars["sdf"] + 1e-2 * sdf_p.abs()).all()),
          f"sdf{tag}: max err {e_sdf.max()}")
    check(bool((e_grad <= bars["grad"] + 5e-2 * grad_p.abs()).all()),
          f"grad{tag}: max err {e_grad.max()}")
    feats_mean = (feats_k - feats_p).abs().mean().item()
    check(feats_mean < 5e-3, f"feats{tag}: mean err {feats_mean}")
    fwd_err = max(e_sdf.max().item(), e_grad.max().item())
    print(f"sdf_grad_fwd{tag}  max|d sdf| {e_sdf.max().item():.3e} (atol {bars['sdf']:.1e} rtol "
          f"1e-2)  max|d grad| {e_grad.max().item():.3e} (atol {bars['grad']:.1e} rtol 5e-2)  "
          f"mean|d feats| {feats_mean:.3e} (< 5e-3)")
    if full:
        # a ragged size (the wrapper pads to the 32-point tile) at the same bars
        odd = pts[:1001]
        with torch.no_grad():
            o_k, o_p = K.sdf_with_grad(params, odd, cfg), K.sdf_with_grad_plain(params, odd, cfg)
        check(all(a.shape == b.shape for a, b in zip(o_k, o_p)), "sdf_grad: ragged shapes")
        e_odd = [(a - b).abs() for a, b in zip(o_k, o_p)]
        check(bool((e_odd[0] <= 5e-3 + 1e-2 * o_p[0].abs()).all())
              and bool((e_odd[2] <= 2e-2 + 5e-2 * o_p[2].abs()).all())
              and e_odd[1].mean().item() < 5e-3,
              f"sdf_grad at n = 1001: max errs sdf {e_odd[0].max()}, grad {e_odd[2].max()}, "
              f"mean feats {e_odd[1].mean()}")
        # no points: empty outputs and parameter gradients that are exactly zero
        z_out = K.sdf_with_grad(params, pts[:0], cfg)
        check([tuple(o.shape) for o in z_out] == [(0, 1), (0, 256), (0, 3)],
              f"sdf_grad zero rows: shapes {[tuple(o.shape) for o in z_out]}")
        g_zero = torch.autograd.grad(sum(o.sum() for o in z_out), leaves(params))
        check(all(not g.any() for g in g_zero), "sdf_grad zero rows: non-zero parameter gradients")
        print(f"sdf_grad_fwd  n = 1001: max|d sdf| {e_odd[0].max().item():.3e}  max|d grad| "
              f"{e_odd[2].max().item():.3e}  mean|d feats| {e_odd[1].mean().item():.3e}; "
              f"n = 0: shapes (0,1) (0,256) (0,3), parameter gradients zero")

    def loss(fn):
        sdf, feats, grad = fn(params, pts, cfg)
        eik = ((torch.linalg.norm(grad, dim=-1) - 1.0) ** 2).mean()
        return (sdf ** 2).mean() + 0.1 * eik + (feats * cot).mean()

    p_leaves = leaves(params)
    g_k = torch.autograd.grad(loss(K.sdf_with_grad), p_leaves)
    g_p = torch.autograd.grad(loss(K.sdf_with_grad_plain), p_leaves)
    bwd_err = grad_err_normalised(g_p, g_k)
    check(bwd_err <= bars["param_grads"], f"sdf{tag} param grads: normalised max err {bwd_err}")
    print(f"sdf_grad_bwd{tag}  param grads max|d|/max|g| {bwd_err:.3e} "
          f"(atol {bars['param_grads']:.1e})")

    # times: the kernel launches alone (`ms`), the wrapper's whole call, and
    # the plain version's same work
    layers = resolve_weight_norm(params)
    with torch.no_grad():
        W, bias = K.pack_weights([l["w"] for l in layers], [l["b"] for l in layers])
    beta, scale = float(cfg.beta), float(cfg.scale)
    g_sdf, g_grad = torch.ones(n, device=dev) / n, grad_k.contiguous() / n
    ms_fwd = cuda_ms(lambda: K._fwd(pts, W, bias, beta, scale, multires))
    ms_bwd = cuda_ms(lambda: K._bwd(pts, W, bias, beta, scale, g_sdf, g_grad, cot, multires),
                     iters=5)
    with torch.no_grad():
        wrap_fwd = cuda_ms(lambda: K.sdf_with_grad(params, pts, cfg))
        plain_fwd = cuda_ms(lambda: K.sdf_with_grad_plain(params, pts, cfg))
    wrap_bwd = cuda_ms_split(lambda: loss(K.sdf_with_grad),
                             lambda l: torch.autograd.grad(l, p_leaves))
    plain_bwd = cuda_ms_split(lambda: loss(K.sdf_with_grad_plain),
                              lambda l: torch.autograd.grad(l, p_leaves))
    out = []
    for name, err, ms, wms, pms, bwd, line in (
            ("sdf_grad_fwd", fwd_err, ms_fwd, wrap_fwd, plain_fwd, False, 363),
            ("sdf_grad_bwd", bwd_err, ms_bwd, wrap_bwd, plain_bwd, True, 387)):
        b_ms, b_by = bound(K.flops(n, bwd, multires), K.min_bytes(n, bwd, multires))
        out.append({"name": K.counter(name, multires), "route": "cuda",
                    "source": "nero_tpu_torch/csrc/sdf_grad.cu",
                    "replaces": f"nero_tpu/ops/pallas/sdf_grad_kernel.py:{line}",
                    "max_abs_err": err, "ms": ms, "launch_ms": ms, "wrapper_ms": wms,
                    "plain_ms": pms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    if not full:  # the build's registers and spills, reported
        from nero_tpu_torch.ops.cuda_build import ptxas_info
        for row, kern in zip(out, ("sdf_grad_fwd_kernel", "sdf_bwd_sweep_kernel")):
            row["ptxas"] = {kern: ptxas_info("sdf_grad", kern, K.defines(multires))}
        print(f"sdf_grad{tag}  launch fwd {ms_fwd:.3f} bwd {ms_bwd:.3f} ms, bounds "
              f"{out[0]['bound_ms']:.3f} / {out[1]['bound_ms']:.3f}; ptxas "
              f"{out[0]['ptxas']} {out[1]['ptxas']}")
        return out
    # the backward's two parts alone, on the wrapper's buffers: recompute +
    # reverse sweep, then the weight- and bias-gradient pass with its reduction
    from nero_tpu_torch.ops.cuda_build import check as check_rc, ptxas_info
    lib, stream = K._lib(), torch.cuda.current_stream(dev).cuda_stream
    scratch, part = K.bwd_buffers(n, dev)
    dW, db = torch.zeros(W.numel(), device=dev), torch.zeros(9, K.OUT_W, device=dev)
    sweep_ms = cuda_ms(lambda: check_rc(lib.sdf_grad_bwd_sweep(
        pts.data_ptr(), n, W.data_ptr(), bias.data_ptr(), beta, scale, g_sdf.data_ptr(),
        g_grad.data_ptr(), cot.data_ptr(), scratch.data_ptr(), stream), "sweep"), iters=5)
    params_ms = cuda_ms(lambda: check_rc(lib.sdf_grad_bwd_params(
        n, scratch.data_ptr(), part.data_ptr(), dW.data_ptr(), db.data_ptr(), stream),
        "params"), iters=5)
    buf_bytes = scratch.numel() * 2 + part.numel() * 4
    del scratch, part
    out[1].update({"sweep_ms": sweep_ms, "params_ms": params_ms, "scratch_bytes": buf_bytes})
    out[0].update(ptxas_info("sdf_grad", "sdf_grad_fwd_kernel"))
    check(out[0].get("spill_bytes") == 0, f"sdf_grad_fwd_kernel spills: {out[0]}")
    ptx = {k: ptxas_info("sdf_grad", k) for k in
           ("sdf_bwd_sweep_kernel", "sdf_bwd_params_kernel", "sdf_bwd_reduce_kernel")}
    check(all(v.get("spill_bytes") == 0 for v in ptx.values()), f"sdf_grad backward spills: {ptx}")
    out[1]["ptxas"] = ptx
    print(f"sdf_grad_bwd  launch {ms_bwd:.3f} ms = recompute + sweep {sweep_ms:.3f} + parameter "
          f"pass {params_ms:.3f}; scratch + partials {buf_bytes / 1e9:.3f} GB at N = {n}; "
          f"ptxas fwd {out[0]['regs']} regs, " + ", ".join(
              f"{k} {v['regs']} regs {v['spill_bytes']} spill bytes" for k, v in ptx.items()))
    return out


def random_human_poses(rng, n: int) -> np.ndarray:
    """[n, 3, 4] camera frames: random rotations (QR) and translations in
    [-0.5, 0.5], so that the camera-plane intersection has hit and miss rows."""
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    return np.concatenate([q, rng.uniform(-0.5, 0.5, (n, 3, 1))], -1).astype(np.float32)


def check_shader(n: int, dev, sphere: bool = False, human: bool = False, enc=(5, 8),
                 full: bool = True) -> list:
    """The whole-shader kernel of one variant at the encodings enc =
    (ide_deg, light_pos_freq), forward and backward, against its plain
    version, with tests/test_shader_kernel.py's bars. `full`: also n = 1,001
    and 0 rows, the same bits in two calls, the backward's parts timed apart
    and the ptxas spill gate (the shipped build's)."""
    from nero_tpu_torch.fields.app_shading import (AppShadingConfig, init_app_shading,
                                                   shade_from_raw)
    from nero_tpu_torch.ops import shader as K
    from nero_tpu_torch.ops.fg_lut import get_fg_lut

    cfg = AppShadingConfig(sphere_direction=sphere, human_light=human, ide_deg=enc[0],
                           light_pos_freq=enc[1])
    sfx = K.variant(cfg)
    params = init_app_shading(torch.Generator().manual_seed(0), cfg, device=dev)
    fg_lut = torch.as_tensor(get_fg_lut(), device=dev)
    rng = np.random.default_rng(1)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    pts = t(rng.uniform(-0.6, 0.6, (n, 3))).requires_grad_(True)
    normals = t(rng.standard_normal((n, 3))).requires_grad_(True)
    view = t(rng.standard_normal((n, 3))).requires_grad_(True)
    feats = t(rng.standard_normal((n, 256)) * 0.3).requires_grad_(True)
    cot = t(rng.standard_normal((n, 3)))
    cot2 = t(rng.standard_normal((n, 1)))
    poses = torch.as_tensor(random_human_poses(rng, n), device=dev) if human else None

    def raw(fn, m: int = n):  # the first m rows
        return fn(params, cfg, pts[:m], normals[:m], view[:m], feats[:m],
                  poses[:m] if human else None)

    def shade(fn, m: int = n):
        return shade_from_raw(raw(fn, m), cfg, fg_lut)

    with torch.no_grad():
        color_k, occ_k = shade(K.shader_raw)
        color_p, occ_p = shade(K.shader_raw_plain)
    e_col = (color_k - color_p).abs().max().item()
    e_occ = (occ_k["occ_prob"] - occ_p["occ_prob"]).abs().max().item()
    e_ref = (occ_k["reflective"] - occ_p["reflective"]).abs().max().item()
    check(e_col <= 2e-3 and e_occ <= 2e-3, f"shader color {e_col} occ_prob {e_occ}")
    check(e_ref <= 1e-5, f"shader reflective {e_ref}")
    print(f"shader_fwd{sfx}    max|d color| {e_col:.3e}  max|d occ_prob| {e_occ:.3e} (atol 2e-3)  "
          f"max|d reflective| {e_ref:.3e} (atol 1e-5)")
    if human:
        with torch.no_grad():
            raw_k, raw_p = K.unpack_raw(raw(K.shader_raw), True), K.unpack_raw(
                raw(K.shader_raw_plain), True)
        hit_rate = raw_p["human_hits"].mean().item()
        same_hits = (raw_k["human_hits"] == raw_p["human_hits"]).float().mean().item()
        both = (raw_k["human_hits"] * raw_p["human_hits"]) > 0
        e_hum = ((torch.exp(raw_k["human_z"].clamp(max=0.0))
                  - torch.exp(raw_p["human_z"].clamp(max=0.0))).abs() * both).max().item()
        # the hit mask is a threshold on f32 values: compared as a rate
        check(0.02 < hit_rate < 0.98, f"human hit rate {hit_rate}: the check is vacuous")
        check(same_hits >= 0.9999 and e_hum <= 3e-3, f"human: hits {same_hits}, value {e_hum}")
        print(f"shader_fwd{sfx}    human hit rate {hit_rate:.3f}, same hit mask {same_hits:.6f} "
              f"(>= 0.9999), max|d human| after exp {e_hum:.3e} (atol 3e-3)")

    def loss(fn, bf16: bool = False, m: int = n):
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=bf16):
            c, o = shade(fn, m)
        return (c.float() * cot[:m]).sum() + (o["occ_prob"].float() * cot2[:m]).sum()

    def worst_cosine(ga, gb) -> float:
        return min((a.flatten() @ b.flatten() / (a.norm() * b.norm() + 1e-12)).item()
                   for a, b in zip(ga, gb))

    def worst_mean_rel(ga, gb) -> float:
        return max(((a - b).abs().mean() / (a.abs().max() + 1e-8)).item()
                   for a, b in zip(ga, gb))

    wrt = leaves(params) + [pts, normals, view, feats]
    g_p = torch.autograd.grad(loss(K.shader_raw_plain), wrt)
    g_k = torch.autograd.grad(loss(K.shader_raw), wrt)
    g_b = torch.autograd.grad(loss(K.shader_raw_plain, bf16=True), wrt)
    worst_cos = worst_cosine(g_p, g_k)
    noise_ker, noise_bf16 = worst_mean_rel(g_p, g_k), worst_mean_rel(g_p, g_b)
    # test_shader_kernel.py's bars against the f32 reference: every leaf
    # within 0.99 cosine, and a worst mean error (normalised by the leaf's
    # max) under 4x that of the plain version run in bf16 (autocast) + 1e-3
    # (the human variants: 0.98 and + 2e-3, test_human_light_grad_parity)
    min_cos, slack = (0.98, 2e-3) if human else (0.99, 1e-3)
    check(worst_cos > min_cos, f"shader{sfx} grads: worst cosine {worst_cos}")
    check(noise_ker < 4.0 * noise_bf16 + slack,
          f"shader{sfx} grads: {noise_ker} vs bf16 {noise_bf16}")
    if human:
        g_hum = sum(g.norm().item() for g in torch.autograd.grad(
            loss(K.shader_raw_plain), leaves(params["human_light"])))
        check(g_hum > 1e-6, "the human head got no gradient: the check is vacuous")
    # reported in the same unit as the SDF's param grads: the worst leaf's
    # max|d| / max|g|
    bwd_err = grad_err_normalised(g_p, g_k)
    print(f"shader_bwd{sfx}    grads worst cosine {worst_cos:.5f} (> {min_cos})  worst mean|d|/max|g| "
          f"{noise_ker:.3e} (< 4 x bf16 {noise_bf16:.3e} + {slack})  worst max|d|/max|g| "
          f"{bwd_err:.3e} (bf16 plain: {grad_err_normalised(g_p, g_b):.3e})")
    if full:
        # a ragged size (both directions' tiles are 128 rows) at the same bars,
        # and no rows: empty outputs, parameter gradients exactly 0
        m = 1001
        with torch.no_grad():
            (c_k, o_k), (c_p, o_p) = shade(K.shader_raw, m), shade(K.shader_raw_plain, m)
        e_odd = max((c_k - c_p).abs().max().item(), (o_k["occ_prob"] - o_p["occ_prob"]).abs().max().item())
        cos_odd = worst_cosine(torch.autograd.grad(loss(K.shader_raw_plain, m=m), wrt),
                               torch.autograd.grad(loss(K.shader_raw, m=m), wrt))
        check(e_odd <= 2e-3 and cos_odd > min_cos,
              f"shader{sfx} at n = {m}: max err {e_odd}, grads worst cosine {cos_odd}")
        c_0, o_0 = shade(K.shader_raw, 0)
        check(tuple(c_0.shape) == (0, 3) and tuple(o_0["occ_prob"].shape) == (0, 1),
              f"shader{sfx} zero rows: shapes {tuple(c_0.shape)}, {tuple(o_0['occ_prob'].shape)}")
        g_0 = torch.autograd.grad(loss(K.shader_raw, m=0), leaves(params))
        check(all(not g.any() for g in g_0), f"shader{sfx} zero rows: non-zero parameter gradients")
        print(f"shader_bwd{sfx}    n = {m}: max|d color, occ_prob| {e_odd:.3e}, grads worst cosine "
              f"{cos_odd:.5f}; n = 0: shapes (0,3) (0,1), parameter gradients zero")

    # times: the wrapper's whole call (`ms`: weight norm, packing, launch, and
    # for the backward autograd and unpacking), the kernel launches alone on
    # packed weights, and the plain version's same work
    gout = t(rng.standard_normal((n, K.OUT)))
    with torch.no_grad():
        ms_fwd = cuda_ms(lambda: raw(K.shader_raw))
        plain_fwd = cuda_ms(lambda: raw(K.shader_raw_plain))
        geo, feats2d, spec, ws, bs = K.kernel_inputs(params, cfg, pts, normals, view, feats,
                                                     poses)
        W, B = K.pack_weights(ws, bs, spec[2])
        launch_fwd = cuda_ms(lambda: K._fwd(geo, feats2d, W, B, *spec[:2], enc))
        launch_bwd = cuda_ms(lambda: K._bwd(geo, feats2d, W, B, *spec[:2], gout, enc))
    ms_bwd = cuda_ms_split(lambda: raw(K.shader_raw),
                           lambda o: torch.autograd.grad(o, wrt, gout))
    plain_bwd = cuda_ms_split(lambda: raw(K.shader_raw_plain),
                              lambda o: torch.autograd.grad(o, wrt, gout, allow_unused=True))
    out = []
    for name, err, ms, lms, pms, bwd, line in (
            (f"shader_fwd{sfx}", max(e_col, e_occ), ms_fwd, launch_fwd, plain_fwd, False, 467),
            (f"shader_bwd{sfx}", bwd_err, ms_bwd, launch_bwd, plain_bwd, True, 494)):
        b_ms, b_by = bound(K.flops(n, cfg, bwd), K.min_bytes(n, cfg, bwd))
        out.append({"name": name, "route": "cuda", "source": "nero_tpu_torch/csrc/shader.cu",
                    "replaces": f"nero_tpu/ops/pallas/shader_kernel.py:{line}",
                    "max_abs_err": err, "ms": ms, "launch_ms": lms, "wrapper_ms": ms,
                    "plain_ms": pms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    out[1]["mean_rel_err"] = noise_ker
    del g_p, g_k, g_b
    if not full:  # the build's registers and spills, reported
        from nero_tpu_torch.ops.cuda_build import ptxas_info
        inst = f"\\w*Lb{int(sphere)}ELb{int(human)}E"
        for row, kern in zip(out, ("shader_fwd_kernel", "shader_bwd_sweep_kernel")):
            row["ptxas"] = {kern: ptxas_info("shader", kern + inst, K.defines(enc))}
        print(f"shader{sfx}    launch fwd {launch_fwd:.3f} bwd {launch_bwd:.3f} ms, wrapper "
              f"{ms_fwd:.3f} / {ms_bwd:.3f}, bounds {out[0]['bound_ms']:.3f} / "
              f"{out[1]['bound_ms']:.3f}; ptxas {out[0]['ptxas']} {out[1]['ptxas']}")
        torch.cuda.empty_cache()
        return out
    # the backward's parts alone, on the wrapper's buffers: recompute + reverse
    # sweep, then the weight- and bias-gradient pass with its reduction; the
    # same packed outputs and gradients to the bit in two calls; no rows, no
    # launch, zeros
    from nero_tpu_torch.ops.cuda_build import check as check_rc, ptxas_info
    sphere_i, human_i = spec[:2]
    with torch.no_grad():
        fwd_first, fwd_second = (K._fwd(geo, feats2d, W, B, sphere_i, human_i) for _ in range(2))
    check(torch.equal(fwd_first, fwd_second), f"shader_fwd{sfx}: two calls differ")
    del fwd_first, fwd_second
    with torch.no_grad():
        first, second = (K._bwd(geo, feats2d, W, B, sphere_i, human_i, gout) for _ in range(2))
    check(all(torch.equal(a, b) for a, b in zip(first, second)),
          f"shader_bwd{sfx}: two calls differ")
    z = K._bwd(geo[:0], feats2d[:0], W, B, sphere_i, human_i, gout[:0])
    check(not z[2].any() and not z[3].any(), f"shader_bwd{sfx} zero rows: dW or dB not zero")
    del first, second, z
    lib, stream = K._lib(), torch.cuda.current_stream(dev).cuda_stream
    scratch, part = K.bwd_buffers(n, sphere_i, human_i, dev)
    dgeo, dfeats = torch.empty(n, K.DGEO, device=dev), torch.empty(n, K.HID, device=dev)
    dW, dB = torch.empty(W.numel(), device=dev), torch.empty_like(B)
    tab = K.ide_table_on(dev)
    sweep_ms = cuda_ms(lambda: check_rc(lib.shader_bwd_sweep(
        geo.data_ptr(), feats2d.data_ptr(), n, W.data_ptr(), B.data_ptr(), tab.data_ptr(),
        sphere_i, human_i, gout.data_ptr(), dgeo.data_ptr(), dfeats.data_ptr(),
        scratch.data_ptr(), stream), "sweep"), iters=5)
    params_ms = cuda_ms(lambda: check_rc(lib.shader_bwd_params(
        n, sphere_i, human_i, scratch.data_ptr(), part.data_ptr(), dW.data_ptr(), dB.data_ptr(),
        stream), "params"), iters=5)
    buf_bytes = scratch.numel() * 2 + part.numel() * 4
    del scratch, part, dgeo, dfeats, dW, dB
    inst = f"\\w*Lb{sphere_i}ELb{human_i}E"  # the variant's template instance
    ptx_fwd = ptxas_info("shader", "shader_fwd_kernel" + inst)
    check(ptx_fwd.get("spill_bytes") == 0, f"shader_fwd{sfx} spills: {ptx_fwd}")
    ptx = {k: ptxas_info("shader", k + inst) for k in
           ("shader_bwd_sweep_kernel", "shader_bwd_params_kernel", "shader_bwd_reduce_kernel")}
    check(all(v.get("spill_bytes") == 0 for v in ptx.values()), f"shader{sfx} backward spills: {ptx}")
    out[0]["ptxas"] = {"shader_fwd_kernel": ptx_fwd}
    out[1].update({"sweep_ms": sweep_ms, "params_ms": params_ms, "scratch_bytes": buf_bytes,
                   "ptxas": ptx})
    print(f"shader_fwd{sfx}    launch {launch_fwd:.3f} ms on {n // K.TILE} tiles of {K.TILE} rows; "
          f"the same packed outputs to the bit in two calls; shader_fwd_kernel "
          f"{ptx_fwd.get('regs')} regs {ptx_fwd.get('spill_bytes')} spill bytes")
    print(f"shader_bwd{sfx}    launch {launch_bwd:.3f} ms = recompute + sweep {sweep_ms:.3f} + "
          f"parameter pass {params_ms:.3f}; scratch + partials {buf_bytes / 1e9:.3f} GB at "
          f"N = {n}; the same dW, dB, dgeo, dfeats to the bit in two calls; " + ", ".join(
              f"{k} {v.get('regs')} regs {v.get('spill_bytes')} spill bytes" for k, v in ptx.items()))
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 2, the scene axis: B1 and B2 launched once for S scenes
# ---------------------------------------------------------------------------

SCENE_COUNTS = (2, 4)   # scenes of one launch, each at N_ROWS rows


def scenes_row(name: str, counter: str, n_scenes: int, source: str, replaces: str, err: float,
               launch_ms: float, wrapper_ms: float, turn_ms: float, plain_ms: float,
               flops: float, nbytes: float, ms: float) -> dict:
    """A kernel row of a launch for S scenes: `one_scene_launches_ms` is S
    one-scene launches in turn, the bound S x one scene's."""
    b_ms, b_by = bound(n_scenes * flops, n_scenes * nbytes)
    return {"name": name, "counter": counter, "scenes": n_scenes, "route": "cuda",
            "source": source, "replaces": replaces, "max_abs_err": err, "ms": ms,
            "launch_ms": launch_ms, "wrapper_ms": wrapper_ms, "one_scene_launches_ms": turn_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def check_sdf_scenes(n: int, n_scenes: int, dev) -> list:
    """B1 with the scene axis: S scenes' SDFs (seeds 3 + s) in one launch
    each way. Each scene's sdf, grad and feats and its dW and db equal its
    one-scene launch to the bit, and the wrapper's outputs and parameter
    gradients equal the one-scene wrapper's; against the plain version scene
    by scene, the bars of check_sdf; the launches, the wrapper and S
    one-scene launches in turn timed."""
    from nero_tpu_torch.fields.sdf import SDFConfig, init_sdf
    from nero_tpu_torch.ops import sdf_grad as K
    from nero_tpu_torch.ops.mlp import resolve_weight_norm
    from nero_tpu_torch.parallel.scenes import stack_trees

    S, cfg = n_scenes, SDFConfig()
    scenes = [init_sdf(torch.Generator().manual_seed(3 + s), cfg, device=dev) for s in range(S)]
    stacked = stack_trees(scenes)
    rng = np.random.default_rng(10 + S)
    pts = torch.as_tensor(rng.uniform(-0.7, 0.7, (S, n, 3)).astype(np.float32), device=dev)
    cot = torch.as_tensor(rng.standard_normal((S, n, 256)).astype(np.float32) * 0.1, device=dev)
    beta, scale = float(cfg.beta), float(cfg.scale)
    tag = f"sdf_grad_scenes S = {S}"

    # the launches on packed weights: each scene's outputs and dW, db to the bit
    with torch.no_grad():
        layers = resolve_weight_norm(stacked)
        W, bias = K.pack_scenes([l["w"] for l in layers], [l["b"] for l in layers])
        fwd_b = K._fwd(pts, W, bias, beta, scale)
        g_sdf, g_grad = torch.ones(S, n, device=dev) / n, fwd_b[1] / n
        bwd_b = K._bwd(pts, W, bias, beta, scale, g_sdf, g_grad, cot)
        for s in range(S):
            one = K._fwd(pts[s], W[s], bias[s], beta, scale)
            check(all(torch.equal(a[s], b) for a, b in zip(fwd_b, one)),
                  f"{tag}: scene {s}'s forward differs from its one-scene launch")
            one = K._bwd(pts[s], W[s], bias[s], beta, scale, g_sdf[s], g_grad[s], cot[s])
            check(all(torch.equal(a[s], b) for a, b in zip(bwd_b, one)),
                  f"{tag}: scene {s}'s dW / db differ from its one-scene launch")
        del fwd_b, bwd_b, one

    def scene_loss(sdf, feats, grad, c):
        eik = ((torch.linalg.norm(grad, dim=-1) - 1.0) ** 2).mean()
        return (sdf ** 2).mean() + 0.1 * eik + (feats * c).mean()

    def loss_b():
        out = K.sdf_with_grad_scenes(stacked, pts, cfg)
        return sum(scene_loss(*(o[s] for o in out), cot[s]) for s in range(S))

    # the wrapper: outputs and parameter gradients those of the one-scene wrapper
    with torch.no_grad():
        out_b = K.sdf_with_grad_scenes(stacked, pts, cfg)
    g_b = torch.autograd.grad(loss_b(), leaves(stacked))
    fwd_err = bwd_err = feats_mean = 0.0
    for s in range(S):
        with torch.no_grad():
            one = K.sdf_with_grad(scenes[s], pts[s], cfg)
            plain = K.sdf_with_grad_plain(scenes[s], pts[s], cfg)
        check(all(torch.equal(a[s], b) for a, b in zip(out_b, one)),
              f"{tag}: scene {s}'s wrapper outputs differ from the one-scene wrapper's")
        g_one = torch.autograd.grad(scene_loss(*K.sdf_with_grad(scenes[s], pts[s], cfg), cot[s]),
                                    leaves(scenes[s]))
        check(all(torch.equal(a[s], b) for a, b in zip(g_b, g_one)),
              f"{tag}: scene {s}'s parameter gradients differ from the one-scene wrapper's")
        e_sdf, e_grad = (out_b[0][s] - plain[0]).abs(), (out_b[2][s] - plain[2]).abs()
        check(bool((e_sdf <= 5e-3 + 1e-2 * plain[0].abs()).all())
              and bool((e_grad <= 2e-2 + 5e-2 * plain[2].abs()).all()),
              f"{tag}: scene {s} against the plain version: sdf {e_sdf.max()}, grad {e_grad.max()}")
        feats_mean = max(feats_mean, (out_b[1][s] - plain[1]).abs().mean().item())
        fwd_err = max(fwd_err, e_sdf.max().item(), e_grad.max().item())
        g_plain = torch.autograd.grad(scene_loss(*K.sdf_with_grad_plain(scenes[s], pts[s], cfg),
                                                 cot[s]), leaves(scenes[s]))
        bwd_err = max(bwd_err, grad_err_normalised(g_plain, [g[s] for g in g_b]))
    check(feats_mean < 5e-3 and bwd_err <= 2e-2,
          f"{tag}: mean|d feats| {feats_mean}, param grads {bwd_err}")
    del out_b, g_b

    def plain_loss():
        return sum(scene_loss(*K.sdf_with_grad_plain(scenes[s], pts[s], cfg), cot[s])
                   for s in range(S))

    launch_fwd = cuda_ms(lambda: K._fwd(pts, W, bias, beta, scale))
    launch_bwd = cuda_ms(lambda: K._bwd(pts, W, bias, beta, scale, g_sdf, g_grad, cot),
                         iters=5)
    turn_fwd = cuda_ms(lambda: [K._fwd(pts[s], W[s], bias[s], beta, scale) for s in range(S)])
    turn_bwd = cuda_ms(lambda: [K._bwd(pts[s], W[s], bias[s], beta, scale, g_sdf[s], g_grad[s],
                                       cot[s]) for s in range(S)], iters=5)
    with torch.no_grad():
        wrap_fwd = cuda_ms(lambda: K.sdf_with_grad_scenes(stacked, pts, cfg))
        plain_fwd = cuda_ms(lambda: [K.sdf_with_grad_plain(scenes[s], pts[s], cfg)
                                     for s in range(S)], iters=3)
    wrap_bwd = cuda_ms_split(loss_b, lambda l: torch.autograd.grad(l, leaves(stacked)))
    plain_bwd = cuda_ms_split(plain_loss, lambda l: torch.autograd.grad(
        l, [x for p in scenes for x in leaves(p)]), iters=3)
    src, rep = "nero_tpu_torch/csrc/sdf_grad.cu", "nero_tpu/ops/pallas/sdf_grad_kernel.py:"
    rows = [scenes_row(f"sdf_grad_fwd_scenes_s{S}", "sdf_grad_fwd_scenes", S, src, rep + "363",
                       fwd_err, launch_fwd, wrap_fwd, turn_fwd, plain_fwd, K.flops(n),
                       K.min_bytes(n), launch_fwd),
            scenes_row(f"sdf_grad_bwd_scenes_s{S}", "sdf_grad_bwd_scenes", S, src, rep + "387",
                       bwd_err, launch_bwd, wrap_bwd, turn_bwd, plain_bwd, K.flops(n, True),
                       K.min_bytes(n, True), launch_bwd)]
    print(f"{tag} x {n} rows: each scene's outputs, dW and db equal to its one-scene launch, "
          f"and the wrapper's outputs and parameter gradients to the one-scene wrapper's, to "
          f"the bit; against the plain version max|d sdf, grad| {fwd_err:.3e}, mean|d feats| "
          f"{feats_mean:.3e}, param grads {bwd_err:.3e}; launch fwd {launch_fwd:.3f} ms (S "
          f"one-scene launches {turn_fwd:.3f}), bwd {launch_bwd:.3f} ms ({turn_bwd:.3f}); "
          f"wrapper {wrap_fwd:.3f} / {wrap_bwd:.3f} ms; bounds {rows[0]['bound_ms']:.3f} / "
          f"{rows[1]['bound_ms']:.3f} ms")
    torch.cuda.empty_cache()
    return rows


def check_shader_scenes(n: int, n_scenes: int, dev, human: bool = False, enc=(5, 8)) -> list:
    """B2 with the scene axis (`default` or `human_light`, at the encodings
    enc): S scenes' shaders (seeds s) in one launch each way. Each scene's packed outputs, dgeo,
    dfeats, dW and dB equal its one-scene launch to the bit, and the
    wrapper's outputs and parameter gradients the one-scene wrapper's;
    against the plain version scene by scene, the bars of check_shader; the
    launches, the wrapper and S one-scene launches in turn timed."""
    from nero_tpu_torch.fields.app_shading import (AppShadingConfig, init_app_shading,
                                                   shade_from_raw)
    from nero_tpu_torch.ops import shader as K
    from nero_tpu_torch.ops.fg_lut import get_fg_lut
    from nero_tpu_torch.parallel.scenes import stack_trees

    S = n_scenes
    cfg = AppShadingConfig(human_light=human, ide_deg=enc[0], light_pos_freq=enc[1])
    sfx = K.variant(cfg)
    tag = f"shader_scenes{sfx} S = {S}"
    scenes = [init_app_shading(torch.Generator().manual_seed(s), cfg, device=dev)
              for s in range(S)]
    stacked = stack_trees(scenes)
    fg_lut = torch.as_tensor(get_fg_lut(), device=dev)
    rng = np.random.default_rng(20 + S)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    pts = t(rng.uniform(-0.6, 0.6, (S * n, 3)))
    normals = t(rng.standard_normal((S * n, 3)))
    view = t(rng.standard_normal((S * n, 3)))
    feats = t(rng.standard_normal((S * n, 256)) * 0.3)
    poses = torch.as_tensor(random_human_poses(rng, S * n), device=dev) if human else None
    cot = t(rng.standard_normal((S * n, 3)))
    cot2 = t(rng.standard_normal((S * n, 1)))
    gout = t(rng.standard_normal((S, n, K.OUT)))
    rows_of = lambda s: slice(s * n, (s + 1) * n)
    args = lambda s: (pts[rows_of(s)], normals[rows_of(s)], view[rows_of(s)],
                      feats[rows_of(s)], poses[rows_of(s)] if human else None)

    # the launches on packed weights: each scene's outputs and gradients to the bit
    with torch.no_grad():
        geo, feats2d, spec, ws, bs = K.kernel_inputs(stacked, cfg, pts, normals, view, feats,
                                                     poses)
        W, B = K.pack_scenes(ws, bs, spec[2])
        geo3, feats3 = geo.view(S, n, -1), feats2d.view(S, n, K.HID)
        sp, hu = spec[:2]
        fwd_b = K._fwd(geo3, feats3, W, B, sp, hu, enc)
        bwd_b = K._bwd(geo3, feats3, W, B, sp, hu, gout, enc)
        for s in range(S):
            check(torch.equal(fwd_b[s], K._fwd(geo3[s], feats3[s], W[s], B[s], sp, hu, enc)),
                  f"{tag}: scene {s}'s forward differs from its one-scene launch")
            one = K._bwd(geo3[s], feats3[s], W[s], B[s], sp, hu, gout[s], enc)
            check(all(torch.equal(a[s], b) for a, b in zip(bwd_b, one)),
                  f"{tag}: scene {s}'s dgeo, dfeats, dW or dB differ from its one-scene launch")
        del fwd_b, bwd_b, one

    def scene_loss(raw, s):
        c, o = shade_from_raw(raw, cfg, fg_lut)
        return (c * cot[rows_of(s)]).sum() + (o["occ_prob"] * cot2[rows_of(s)]).sum()

    def loss_b():
        raw = K.shader_raw_scenes(stacked, cfg, S, pts, normals, view, feats, poses)
        return sum(scene_loss(raw[rows_of(s)], s) for s in range(S))

    with torch.no_grad():
        raw_b = K.shader_raw_scenes(stacked, cfg, S, pts, normals, view, feats, poses)
    g_b = torch.autograd.grad(loss_b(), leaves(stacked))
    e_fwd, worst_cos, worst_rel, bwd_err = 0.0, 1.0, 0.0, 0.0

    def cosine(a, b):
        return (a.flatten() @ b.flatten() / (a.norm() * b.norm() + 1e-12)).item()

    for s in range(S):
        with torch.no_grad():
            raw_1 = K.shader_raw(scenes[s], cfg, *args(s))
            c_b, o_b = shade_from_raw(raw_b[rows_of(s)], cfg, fg_lut)
            c_p, o_p = shade_from_raw(K.shader_raw_plain(scenes[s], cfg, *args(s)), cfg, fg_lut)
        check(torch.equal(raw_b[rows_of(s)], raw_1),
              f"{tag}: scene {s}'s wrapper outputs differ from the one-scene wrapper's")
        g_1 = torch.autograd.grad(scene_loss(K.shader_raw(scenes[s], cfg, *args(s)), s),
                                  leaves(scenes[s]))
        check(all(torch.equal(a[s], b) for a, b in zip(g_b, g_1)),
              f"{tag}: scene {s}'s parameter gradients differ from the one-scene wrapper's")
        e_fwd = max(e_fwd, (c_b - c_p).abs().max().item(),
                    (o_b["occ_prob"] - o_p["occ_prob"]).abs().max().item())
        g_p = torch.autograd.grad(scene_loss(K.shader_raw_plain(scenes[s], cfg, *args(s)), s),
                                  leaves(scenes[s]))
        with torch.autocast("cuda", dtype=torch.bfloat16):
            loss_bf16 = scene_loss(K.shader_raw_plain(scenes[s], cfg, *args(s)), s)
        g_bf = torch.autograd.grad(loss_bf16.float(), leaves(scenes[s]))
        kb = [g[s] for g in g_b]
        worst_cos = min(worst_cos, min(cosine(a, b) for a, b in zip(g_p, kb)))
        rel = lambda ga, gb: max(((a - b).abs().mean() / (a.abs().max() + 1e-8)).item()
                                 for a, b in zip(ga, gb))
        noise, noise_bf16 = rel(g_p, kb), rel(g_p, g_bf)
        min_cos, slack = (0.98, 2e-3) if human else (0.99, 1e-3)
        check(noise < 4.0 * noise_bf16 + slack,
              f"{tag}: scene {s} grads {noise} vs bf16 {noise_bf16}")
        worst_rel = max(worst_rel, noise)
        bwd_err = max(bwd_err, grad_err_normalised(g_p, kb))
    check(e_fwd <= 2e-3 and worst_cos > min_cos,
          f"{tag}: against the plain version max err {e_fwd}, grads worst cosine {worst_cos}")
    del raw_b, g_b

    def plain_raw():
        return [K.shader_raw_plain(scenes[s], cfg, *args(s)) for s in range(S)]

    gout2 = gout.reshape(S * n, K.OUT)
    launch_fwd = cuda_ms(lambda: K._fwd(geo3, feats3, W, B, sp, hu, enc))
    launch_bwd = cuda_ms(lambda: K._bwd(geo3, feats3, W, B, sp, hu, gout, enc), iters=5)
    turn_fwd = cuda_ms(lambda: [K._fwd(geo3[s], feats3[s], W[s], B[s], sp, hu, enc)
                                for s in range(S)])
    turn_bwd = cuda_ms(lambda: [K._bwd(geo3[s], feats3[s], W[s], B[s], sp, hu, gout[s], enc)
                                for s in range(S)], iters=5)
    with torch.no_grad():
        wrap_fwd = cuda_ms(lambda: K.shader_raw_scenes(stacked, cfg, S, pts, normals, view,
                                                       feats, poses))
        plain_fwd = cuda_ms(plain_raw, iters=3)
    wrap_bwd = cuda_ms_split(
        lambda: K.shader_raw_scenes(stacked, cfg, S, pts, normals, view, feats, poses),
        lambda o: torch.autograd.grad(o, leaves(stacked), gout2))
    plain_bwd = cuda_ms_split(
        lambda: torch.cat(plain_raw()),
        lambda o: torch.autograd.grad(o, [x for p in scenes for x in leaves(p)], gout2,
                                      allow_unused=True), iters=3)
    src, rep = "nero_tpu_torch/csrc/shader.cu", "nero_tpu/ops/pallas/shader_kernel.py:"
    rows = [scenes_row(f"shader_fwd_scenes{sfx}_s{S}", f"shader_fwd_scenes{sfx}", S, src,
                       rep + "467", e_fwd, launch_fwd, wrap_fwd, turn_fwd, plain_fwd,
                       K.flops(n, cfg), K.min_bytes(n, cfg), wrap_fwd),
            scenes_row(f"shader_bwd_scenes{sfx}_s{S}", f"shader_bwd_scenes{sfx}", S, src,
                       rep + "494", bwd_err, launch_bwd, wrap_bwd, turn_bwd, plain_bwd,
                       K.flops(n, cfg, True), K.min_bytes(n, cfg, True), wrap_bwd)]
    rows[1]["mean_rel_err"] = worst_rel
    print(f"{tag} x {n} rows: each scene's outputs, dgeo, dfeats, dW and dB equal to its "
          f"one-scene launch, and the wrapper's outputs and parameter gradients to the "
          f"one-scene wrapper's, to the bit; against the plain version max|d color, occ| "
          f"{e_fwd:.3e}, grads worst cosine {worst_cos:.5f}, worst mean|d|/max|g| "
          f"{worst_rel:.3e}, worst max|d|/max|g| {bwd_err:.3e}; launch fwd {launch_fwd:.3f} ms (S one-scene launches "
          f"{turn_fwd:.3f}), bwd {launch_bwd:.3f} ms ({turn_bwd:.3f}); wrapper {wrap_fwd:.3f} / "
          f"{wrap_bwd:.3f} ms; bounds {rows[0]['bound_ms']:.3f} / {rows[1]['bound_ms']:.3f} ms")
    torch.cuda.empty_cache()
    return rows


def check_sdf_fwd_scenes(sizes, n_scenes: int, dev) -> list:
    """B6 with the scene axis: S scenes' SDFs (seeds 3 + s) in one launch at
    each of `sizes` points a scene. Each scene's sdf equals its one-scene
    launch to the bit, and the wrapper's (`sdf_fwd_scenes`) the one-scene
    wrapper's; against the plain version scene by scene, check_sdf_fwd's
    bars; the launch, the wrapper and S one-scene launches in turn timed."""
    from nero_tpu_torch.fields.sdf import SDFConfig, init_sdf
    from nero_tpu_torch.ops import sdf_fwd as K
    from nero_tpu_torch.parallel.scenes import stack_trees

    S, cfg = n_scenes, SDFConfig()
    scenes = [init_sdf(torch.Generator().manual_seed(3 + s), cfg, device=dev) for s in range(S)]
    stacked = stack_trees(scenes)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(30 + S)
    rows, said = [], []
    for n in sizes:
        tag = f"sdf_fwd_scenes S = {S} x {n}"
        pts = torch.as_tensor(rng.uniform(-0.7, 0.7, (S, n, 3)).astype(np.float32), device=dev)
        with torch.no_grad():
            W, bias = K.pack_scenes(stacked, cfg)
            packed = [K.pack_params(scenes[s], cfg) for s in range(S)]
            out_b = K._launch(W, bias, pts, cfg)
            wrap_b = K.sdf_fwd_scenes(stacked, pts, cfg)
            err = 0.0
            for s in range(S):
                check(torch.equal(W[s], packed[s][0]) and torch.equal(bias[s], packed[s][1]),
                      f"{tag}: scene {s}'s packed weights differ from its one-scene pack")
                check(torch.equal(out_b[s], K._launch(W[s], bias[s], pts[s], cfg)),
                      f"{tag}: scene {s} differs from its one-scene launch")
                check(torch.equal(wrap_b[s], K.sdf_fwd(scenes[s], pts[s], cfg)),
                      f"{tag}: scene {s}'s wrapper output differs from the one-scene wrapper's")
                e = (wrap_b[s] - K.sdf_fwd_plain(scenes[s], pts[s], cfg)).abs()
                check(e.max().item() <= 2e-2 and e.mean().item() < 3e-3,
                      f"{tag}: scene {s} against the plain version: max {e.max()}, mean {e.mean()}")
                err = max(err, e.max().item())
            del out_b, wrap_b
            launch = cuda_ms(lambda: K._launch(W, bias, pts, cfg))
            turn = cuda_ms(lambda: [K._launch(*packed[s], pts[s], cfg) for s in range(S)])
            wrapper = cuda_ms(lambda: K.sdf_fwd_scenes(stacked, pts, cfg))
            plain = cuda_ms(lambda: [K.sdf_fwd_plain(scenes[s], pts[s], cfg) for s in range(S)],
                            iters=3)
        row = scenes_row(f"sdf_fwd_scenes_s{S}_n{n}", "sdf_fwd_scenes", S,
                         "nero_tpu_torch/csrc/sdf_fwd.cu", "nero_tpu/ops/pallas/sdf_kernel.py:122",
                         err, launch, wrapper, turn, plain, K.flops(n), K.min_bytes(n), launch)
        row.update(n=n, tile=K.tile(S * n, sms), one_scene_tile=K.tile(n, sms))
        rows.append(row)
        said.append(f"{n}: launch {launch:.4f} ms on {row['tile']}-point tiles (S one-scene "
                    f"launches {turn:.4f} on {row['one_scene_tile']}-point tiles), wrapper "
                    f"{wrapper:.4f}, bound {row['bound_ms']:.4f}, max|d sdf| {err:.3e}")
    print(f"sdf_fwd_scenes S = {S}: each scene equal to its one-scene launch, and the wrapper's "
          f"output to the one-scene wrapper's, to the bit, at " + "; ".join(said))
    torch.cuda.empty_cache()
    return rows


def check_predictor_scenes(n: int, n_scenes: int, dev, shapes=None) -> list:
    """B8 with the scene axis: S scenes' heads (seeds d_in + s) in one launch
    each way for each head shape of the Stage-I shader. Each scene's output,
    dx, dW and dB equal its one-scene launch to the bit, and the wrapper's
    (`predictor_scenes`) outputs and x- and parameter gradients the one-scene
    wrapper's; against the plain version scene by scene, check_predictor's
    bars (its mean-error bar, as at the other encodings, over the leaves of
    more than one entry); the launches, the wrapper and S one-scene launches
    in turn timed."""
    from nero_tpu_torch.fields.app_shading import AppShadingConfig
    from nero_tpu_torch.ops import predictor as K
    from nero_tpu_torch.ops.mlp import init_predictor, resolve_weight_norm
    from nero_tpu_torch.ops.shader import head_dims
    from nero_tpu_torch.parallel.scenes import stack_trees

    S = n_scenes
    # the head shapes of phase 10's multi-scene sphere_heads.yaml (the default variant)
    trained = set(head_dims(AppShadingConfig(fused_shader=False, fused_heads=True)).values())
    rng = np.random.default_rng(40 + S)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    mean_rel = lambda ga, gb: max(((a - b).abs().mean() / (a.abs().max() + 1e-8)).item()
                                  for a, b in zip(ga, gb))
    rows, said, said_one = [], [], []
    for d_in, d_out in shapes or K.SHADER_SHAPES:
        sfx = f"_{d_in}x{d_out}"
        tag = f"predictor_scenes{sfx} S = {S}"
        scenes = [init_predictor(torch.Generator().manual_seed(d_in + s), d_in, d_out,
                                 device=dev) for s in range(S)]
        stacked = stack_trees(scenes)
        x = t(rng.standard_normal((S, n, d_in)) * 0.5)
        gout = t(rng.standard_normal((S, n, d_out)))

        # the launches on packed weights: each scene's outputs and gradients to the bit
        with torch.no_grad():
            res = resolve_weight_norm(stacked)
            W, B = K.pack_scenes([l["w"] for l in res], [l["b"] for l in res])
            fwd_b = K._fwd(x, W, B, d_out)
            bwd_b = K._bwd(x, W, B, gout)
            packed = []
            for s in range(S):
                one_res = resolve_weight_norm(scenes[s])
                packed.append(K.pack_weights([l["w"] for l in one_res],
                                             [l["b"] for l in one_res]))
                check(torch.equal(W[s], packed[s][0]) and torch.equal(B[s], packed[s][1]),
                      f"{tag}: scene {s}'s packed weights differ from its one-scene pack")
                check(torch.equal(fwd_b[s], K._fwd(x[s], W[s], B[s], d_out)),
                      f"{tag}: scene {s}'s forward differs from its one-scene launch")
                one = K._bwd(x[s], W[s], B[s], gout[s])
                check(all(torch.equal(a[s], b) for a, b in zip(bwd_b, one)),
                      f"{tag}: scene {s}'s dx, dW or dB differ from its one-scene launch")
            del fwd_b, bwd_b, one

        # the wrapper: outputs and gradients those of the one-scene wrapper
        xf = x.reshape(S * n, d_in).clone().requires_grad_(True)
        y_b = K.predictor_scenes(stacked, xf, S)
        g_b = torch.autograd.grad(y_b, leaves(stacked) + [xf], gout.reshape(S * n, d_out))
        y_b = y_b.detach().reshape(S, n, d_out)
        g_x = g_b[-1].reshape(S, n, d_in)
        err = noise = dx_err = bwd_err = 0.0
        worst_cos = 1.0
        for s in range(S):
            xs = x[s].clone().requires_grad_(True)
            wrt = leaves(scenes[s]) + [xs]
            y_1 = K.predictor(scenes[s], xs)
            g_1 = torch.autograd.grad(y_1, wrt, gout[s])
            check(torch.equal(y_b[s], y_1.detach()),
                  f"{tag}: scene {s}'s wrapper output differs from the one-scene wrapper's")
            check(all(torch.equal(a[s], b) for a, b in zip(g_b[:-1], g_1[:-1]))
                  and torch.equal(g_x[s], g_1[-1]),
                  f"{tag}: scene {s}'s gradients differ from the one-scene wrapper's")
            y_p = K.predictor_plain(scenes[s], xs)
            g_p = torch.autograd.grad(y_p, wrt, gout[s])
            with torch.autocast("cuda", dtype=torch.bfloat16):
                y_bf = K.predictor_plain(scenes[s], xs).float()
            g_bf = torch.autograd.grad(y_bf, wrt, gout[s])
            e = (y_b[s] - y_p.detach()).abs()
            check(bool((e <= 2e-3 + 1e-2 * y_p.detach().abs()).all()),
                  f"{tag}: scene {s} against the plain version: max err {e.max()}")
            kb = [g[s] for g in g_b[:-1]] + [g_x[s]]
            # the mean-error bar over the leaves of more than one entry, as
            # check_predictor's at the other encodings: a one-output head's
            # output gain is one sum that cancels over the rows, its error
            # reported beside the bf16 plain version's
            many = [i for i, a in enumerate(g_p[:-1]) if a.numel() > 1]
            one_entry = [i for i in range(len(g_p) - 1) if i not in many]
            pick = lambda g, idx: [g[i] for i in idx]
            n_k = mean_rel(pick(g_p, many), pick(kb, many))
            n_bf = mean_rel(pick(g_p, many), pick(g_bf, many))
            if one_entry:
                one_k = mean_rel(pick(g_p, one_entry), pick(kb, one_entry))
                one_bf = mean_rel(pick(g_p, one_entry), pick(g_bf, one_entry))
                said_one.append(f"{d_in}->{d_out} scene {s} {one_k:.2e} (bf16 {one_bf:.2e})")
            cos = min((a.flatten() @ b.flatten() / (a.norm() * b.norm() + 1e-12)).item()
                      for a, b in zip(g_p, kb))
            d_x = mean_rel(g_p[-1:], kb[-1:])
            check(n_k < 1.5 * n_bf + 1e-4 and cos > 0.99 and d_x < 0.02,
                  f"{tag}: scene {s} grads {n_k} vs bf16 {n_bf}, worst cosine {cos}, d x {d_x}")
            err, noise, dx_err = max(err, e.max().item()), max(noise, n_k), max(dx_err, d_x)
            worst_cos = min(worst_cos, cos)
            bwd_err = max(bwd_err, grad_err_normalised(g_p, kb))
        del g_b, g_x, y_b

        def plain_fwd():
            return [K.predictor_plain(scenes[s], x[s]) for s in range(S)]

        with torch.no_grad():
            launch_fwd = cuda_ms(lambda: K._fwd(x, W, B, d_out))
            turn_fwd = cuda_ms(lambda: [K._fwd(x[s], *packed[s], d_out) for s in range(S)])
            launch_bwd = cuda_ms(lambda: K._bwd(x, W, B, gout), iters=5)
            turn_bwd = cuda_ms(lambda: [K._bwd(x[s], *packed[s], gout[s]) for s in range(S)],
                               iters=5)
            wrap_fwd = cuda_ms(lambda: K.predictor_scenes(stacked, xf, S))
            p_fwd = cuda_ms(plain_fwd, iters=3)
        gflat = gout.reshape(S * n, d_out)
        wrap_bwd = cuda_ms_split(lambda: K.predictor_scenes(stacked, xf, S),
                                 lambda o: torch.autograd.grad(o, leaves(stacked) + [xf], gflat))
        xs_all = [x[s].clone().requires_grad_(True) for s in range(S)]
        p_bwd = cuda_ms_split(
            lambda: torch.cat([K.predictor_plain(scenes[s], xs_all[s]) for s in range(S)]),
            lambda o: torch.autograd.grad(o, [v for p in scenes for v in leaves(p)] + xs_all,
                                          gflat), iters=3)
        src, rep = "nero_tpu_torch/csrc/predictor.cu", "nero_tpu/ops/pallas/predictor_kernel.py:"
        rows += [scenes_row(f"predictor_fwd_scenes{sfx}_s{S}", f"predictor_fwd_scenes{sfx}", S,
                            src, rep + "151", err, launch_fwd, wrap_fwd, turn_fwd, p_fwd,
                            K.flops(n, d_in, d_out), K.min_bytes(n, d_in, d_out), wrap_fwd),
                 scenes_row(f"predictor_bwd_scenes{sfx}_s{S}", f"predictor_bwd_scenes{sfx}", S,
                            src, rep + "171", bwd_err, launch_bwd, wrap_bwd, turn_bwd, p_bwd,
                            K.flops(n, d_in, d_out, True), K.min_bytes(n, d_in, d_out, True),
                            wrap_bwd)]
        rows[-1]["mean_rel_err"] = noise
        if (d_in, d_out) not in trained:
            for r in rows[-2:]:
                r.update(on_path=False, note="checked in the kernel phase; no multi-scene "
                                             "training run of this script takes this head")
        said.append(f"{d_in}->{d_out}: launch fwd {launch_fwd:.3f} ({turn_fwd:.3f}), bwd "
                    f"{launch_bwd:.3f} ({turn_bwd:.3f}), wrapper {wrap_fwd:.3f} / {wrap_bwd:.3f}, "
                    f"bounds {rows[-2]['bound_ms']:.3f} / {rows[-1]['bound_ms']:.3f}; max|d| "
                    f"{err:.2e}, worst cosine {worst_cos:.5f}, mean|d|/max|g| {noise:.2e}, "
                    f"d x {dx_err:.2e}")
        torch.cuda.empty_cache()
    print(f"predictor_scenes S = {S} x {n} rows: each scene's output, dx, dW and dB equal to its "
          f"one-scene launch, and the wrapper's output and gradients to the one-scene "
          f"wrapper's, to the bit; ms (S one-scene launches in brackets): " + "; ".join(said))
    print(f"predictor_scenes S = {S}: one-entry leaves' mean|d|/max|g| " + ", ".join(said_one))
    return rows


def check_scene_kernels(dev) -> list:
    """B1, B2 (`default`, `human_light`), B6 (at the occlusion march's, the
    sampler's and its up-samples' sizes) and B8 (the Stage-I shader's head
    shapes) with the scene axis at each of SCENE_COUNTS."""
    rows = []
    for s in SCENE_COUNTS:
        rows += check_sdf_scenes(N_ROWS, s, dev)
        rows += check_shader_scenes(N_ROWS, s, dev)
        rows += check_shader_scenes(N_ROWS, s, dev, human=True)
        rows += check_sdf_fwd_scenes((N_OCC_MARCH, N_SAMPLER, N_UPSAMPLE), s, dev)
        rows += check_predictor_scenes(N_ROWS, s, dev)
    return rows


def check_sdf_fwd_at(n: int, multires: int, dev) -> list:
    """B6 at another `multires` (live PE weights): against its plain version
    at n points with check_sdf_fwd's bars, equal to the bit to B1's sdf at
    the same multires there, timed at n (launch, wrapper, plain), its ptxas
    reported."""
    from nero_tpu_torch.fields.sdf import SDFConfig
    from nero_tpu_torch.ops import sdf_fwd as K
    from nero_tpu_torch.ops.cuda_build import ptxas_info
    from nero_tpu_torch.ops.sdf_grad import sdf_with_grad

    from nero_tpu_torch.kernel_variants import sdf_params

    cfg = SDFConfig(multires=multires)
    params = sdf_params(cfg, dev)
    name = K.counter("sdf_fwd", multires)
    rng = np.random.default_rng(1)
    pts = torch.as_tensor(rng.uniform(-0.7, 0.7, (n, 3)).astype(np.float32), device=dev)
    with torch.no_grad():
        v_k, v_p = K.sdf_fwd(params, pts, cfg), K.sdf_fwd_plain(params, pts, cfg)
        v_g = sdf_with_grad(params, pts, cfg)[0]
    err = (v_k - v_p).abs()
    check(err.max().item() <= 2e-2 and err.mean().item() < 3e-3,
          f"{name}: max err {err.max()}, mean {err.mean()}")
    check(torch.equal(v_k, v_g), f"{name} against sdf_grad's sdf: max |d| {(v_k - v_g).abs().max()}")
    packed = K.pack_params(params, cfg)
    ms = cuda_ms(lambda: K.sdf_fwd_packed(packed, pts, cfg))
    b_ms, b_by = bound(K.flops(n, multires), K.min_bytes(n, multires))
    entry = {"name": name, "route": "cuda", "source": "nero_tpu_torch/csrc/sdf_fwd.cu",
             "replaces": "nero_tpu/ops/pallas/sdf_kernel.py:122", "max_abs_err": err.max().item(),
             "ms": ms, "launch_ms": ms,
             "wrapper_ms": cuda_ms(lambda: K.sdf_fwd(params, pts, cfg)),
             "plain_ms": cuda_ms(lambda: K.sdf_fwd_plain(params, pts, cfg)),
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "n": n,
             "ptxas": {"sdf_fwd_kernel<2>": ptxas_info("sdf_fwd", r"sdf_fwd_kernelILi2E",
                                                       K.defines(multires))}}
    print(f"{name}  max|d sdf| {err.max().item():.3e} (atol 2e-2), mean {err.mean().item():.3e} "
          f"(< 3e-3) at N = {n}; equal to sdf_grad{K.counter('', multires)}'s sdf to the bit; "
          f"launch {ms:.3f} ms, bound {b_ms:.3f}; ptxas {entry['ptxas']}")
    return [entry]


def check_sdf_fwd(n: int, n_small: int, dev) -> list:
    """The value-only SDF kernel against its plain (f32) version at the
    occlusion march's first-pass size `n` and the sampler's `n_small`, with
    the bars of tests/test_pallas_kernels.py (atol 2e-2, mean error under
    3e-3: bf16 operands), and equal to the bit to the sdf of the
    SDF-with-gradient kernel, which runs the same arithmetic on the same
    engine: at `n_small` points and at a ragged size (3 x 1001 points, which
    B1's wrapper pads) with a scale other than 1. Its two tile sizes give the
    same bits; neither instance spills, nor does B1's forward after the lift.
    Timed at `n`, `n_small` and N_UPSAMPLE, the sizes of the sampler's and
    the occlusion march's launches, and on both sides of the tile rule's
    threshold (64 points a tile up to 64 x the card's SM count)."""
    from nero_tpu_torch.fields.sdf import SDFConfig, init_sdf
    from nero_tpu_torch.ops import sdf_fwd as K
    from nero_tpu_torch.ops.cuda_build import ptxas_info
    from nero_tpu_torch.ops.sdf_grad import sdf_with_grad

    cfg = SDFConfig()
    params = init_sdf(torch.Generator().manual_seed(3), cfg, device=dev)
    rng = np.random.default_rng(1)
    pts = torch.as_tensor(rng.uniform(-0.7, 0.7, (n, 3)).astype(np.float32), device=dev)
    with torch.no_grad():
        v_k, v_p = K.sdf_fwd(params, pts, cfg), K.sdf_fwd_plain(params, pts, cfg)
        v_g = sdf_with_grad(params, pts[:n_small], cfg)[0]
        v_small = K.sdf_fwd(params, pts[:N_UPSAMPLE], cfg)
    err = (v_k - v_p).abs()
    check(err.max().item() <= 2e-2 and err.mean().item() < 3e-3,
          f"sdf_fwd: max err {err.max()}, mean {err.mean()}")
    check(torch.equal(v_k[:n_small], v_g),
          f"sdf_fwd against sdf_grad's sdf: max |d| {(v_k[:n_small] - v_g).abs().max()}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = (K.tile(N_UPSAMPLE, sms), K.tile(n, sms))
    check(torch.equal(v_small, v_k[:N_UPSAMPLE]),
          f"sdf_fwd: {tiles[0]}-point tiles differ from {tiles[1]}-point tiles")
    # ragged tail, leading shape, scale != 1
    cfg2 = cfg._replace(scale=1.3)
    odd = pts[:3 * 1001].reshape(3, 1001, 3)
    with torch.no_grad():
        o_k, o_p = K.sdf_fwd(params, odd, cfg2), K.sdf_fwd_plain(params, odd, cfg2)
        o_g = sdf_with_grad(params, odd, cfg2)[0]
    check(o_k.shape == (3, 1001, 1), f"sdf_fwd shape {o_k.shape}")
    e_odd = (o_k - o_p).abs()
    check(e_odd.max().item() <= 2e-2 and e_odd.mean().item() < 3e-3,
          f"sdf_fwd (3 x 1001 points, scale 1.3): max err {e_odd.max()}, mean {e_odd.mean()}")
    check(torch.equal(o_k, o_g), f"sdf_fwd against sdf_grad's sdf at 3 x 1001 points, scale 1.3: "
                                 f"max |d| {(o_k - o_g).abs().max()}")
    ptx = {k: ptxas_info("sdf_fwd", pat) for k, pat in
           (("sdf_fwd_kernel<2>", r"sdf_fwd_kernelILi2E"),
            ("sdf_fwd_kernel<1>", r"sdf_fwd_kernelILi1E"))}
    ptx["sdf_grad_fwd_kernel"] = ptxas_info("sdf_grad", "sdf_grad_fwd_kernel")
    check(all(v.get("spill_bytes") == 0 for v in ptx.values()), f"sdf_fwd spills: {ptx}")
    print(f"sdf_fwd       max|d sdf| {err.max().item():.3e} (atol 2e-2), mean "
          f"{err.mean().item():.3e} (< 3e-3) at N = {n}; equal to sdf_grad's sdf to the bit at "
          f"N = {n_small} and at 3 x 1001 points at scale 1.3 ({e_odd.max().item():.3e} from the "
          f"plain version); {tiles[0]}- and {tiles[1]}-point tiles the same bits; " + ", ".join(
              f"{k} {v.get('regs')} regs {v.get('spill_bytes')} spill bytes"
              for k, v in ptx.items()))
    packed = K.pack_params(params, cfg)
    entry = {"name": "sdf_fwd", "route": "cuda", "source": "nero_tpu_torch/csrc/sdf_fwd.cu",
             "replaces": "nero_tpu/ops/pallas/sdf_kernel.py:122", "max_abs_err": err.max().item(),
             "library_ms": None, "n": n, "ptxas": ptx}
    # `ms`: the launch on packed weights, which is what the renderer calls
    # (it packs once a step and launches 4-6 times); `wrapper_ms` packs too.
    # Timed also at the sampler's up-sample size, 3 of its 4 launches a step,
    # and on both sides of the tile rule's threshold
    thr = K.SMALL_TILE * sms
    sizes = [n, n_small, N_UPSAMPLE, thr, thr + K.SMALL_TILE]
    said = []
    for m in sizes:
        key = "" if m == n else f"_n{m}"
        sub = pts[:m].contiguous()
        entry["ms" + key] = cuda_ms(lambda: K.sdf_fwd_packed(packed, sub, cfg))
        entry["launch_ms" + key] = entry["ms" + key]
        entry["tile" + key] = K.tile(m, sms)
        entry["wrapper_ms" + key] = cuda_ms(lambda: K.sdf_fwd(params, sub, cfg))
        entry["plain_ms" + key] = cuda_ms(lambda: K.sdf_fwd_plain(params, sub, cfg))
        entry["bound_ms" + key], entry["bound_by" + key] = bound(K.flops(m), K.min_bytes(m))
        said.append(f"{entry['ms' + key]:.4f} at {m} ({entry['tile' + key]}-point tiles)")
    print("sdf_fwd       launch ms " + ", ".join(said))
    return [entry]


def check_predictor(n: int, dev, shapes=None, full: bool = True) -> list:
    """The predictor kernel, forward and backward, against its plain version
    for every head shape of the Stage-I shader (all its variants:
    `ops/predictor.py::SHADER_SHAPES`), with tests/test_predictor_kernel.py's bars:
    values atol 2e-3 + rtol 1e-2 (at n and at 1,001 rows, the same bits in
    two calls, 0 spill bytes); parameter gradients' worst mean error
    (normalised by each leaf's max) under 1.5x that of the plain version with
    bf16 products + 1e-4, every leaf within cosine 0.99; the input cotangent's
    mean error under 0.02 of its max. `shapes`: (d_in, d_out) pairs other
    than those; not `full`: without the ragged and zero-row checks, the two
    calls and the parts' times."""
    from nero_tpu_torch.ops import predictor as K
    from nero_tpu_torch.ops.mlp import init_predictor, resolve_weight_norm

    rng = np.random.default_rng(2)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    mean_rel = lambda ga, gb: max(((a - b).abs().mean() / (a.abs().max() + 1e-8)).item()
                                  for a, b in zip(ga, gb))
    out = []
    for d_in, d_out in shapes or K.SHADER_SHAPES:
        layers = init_predictor(torch.Generator().manual_seed(d_in), d_in, d_out, device=dev)
        x = t(rng.standard_normal((n, d_in)) * 0.5).requires_grad_(True)
        cot = t(rng.standard_normal((n, d_out)))
        sfx = f"_{d_in}x{d_out}"

        def plain_bf16(layers, x):
            with torch.autocast("cuda", dtype=torch.bfloat16):
                return K.predictor_plain(layers, x).float()

        with torch.no_grad():
            y_k, y_p = K.predictor(layers, x), K.predictor_plain(layers, x)
        err = (y_k - y_p).abs()
        check(bool((err <= 2e-3 + 1e-2 * y_p.abs()).all()), f"predictor{sfx}: max err {err.max()}")
        wrt = leaves(layers) + [x]
        g_p = torch.autograd.grad((K.predictor_plain(layers, x) * cot).sum(), wrt)
        g_k = torch.autograd.grad((K.predictor(layers, x) * cot).sum(), wrt)
        g_b = torch.autograd.grad((plain_bf16(layers, x) * cot).sum(), wrt)
        # the mean-error bar: at the other encodings' shapes over the leaves
        # of more than one entry (a one-output head's output gain is one sum
        # that cancels over the rows: on the H100 its error scatters over
        # 3e-4-4e-2 in the kernel, its rounding emulation and the bf16 plain
        # version alike, PERF.md section 6), its error reported beside the
        # bf16 one
        bar = [i for i, a in enumerate(g_p[:-1]) if full or a.numel() > 1]
        pick = lambda g: [g[i] for i in bar]
        noise_ker, noise_bf16 = mean_rel(pick(g_p), pick(g_k)), mean_rel(pick(g_p), pick(g_b))
        worst_cos = min((a.flatten() @ b.flatten() / (a.norm() * b.norm() + 1e-12)).item()
                        for a, b in zip(g_p, g_k))
        dx_err = mean_rel(g_p[-1:], g_k[-1:])
        one = [i for i in range(len(g_p) - 1) if i not in bar]
        if one:
            leaf = lambda g: [g[i] for i in one]
            print(f"predictor{sfx}  one-entry leaves' mean|d|/max|g| "
                  f"{mean_rel(leaf(g_p), leaf(g_k)):.3e}, bf16 plain "
                  f"{mean_rel(leaf(g_p), leaf(g_b)):.3e}")
        check(noise_ker < 1.5 * noise_bf16 + 1e-4,
              f"predictor{sfx} grads: {noise_ker} vs bf16 {noise_bf16}")
        check(worst_cos > 0.99, f"predictor{sfx} grads: worst cosine {worst_cos}")
        check(dx_err < 0.02, f"predictor{sfx}: d x mean error {dx_err}")
        bwd_err = grad_err_normalised(g_p, g_k)
        print(f"predictor{sfx}  fwd max|d| {err.max().item():.3e} (atol 2e-3 rtol 1e-2)  grads "
              f"worst cosine {worst_cos:.5f} (> 0.99)  worst mean|d|/max|g| {noise_ker:.3e} "
              f"(< 1.5 x bf16 {noise_bf16:.3e} + 1e-4)  d x {dx_err:.3e} (< 0.02)")
        # times: the wrapper's whole call (`ms`, as for the shader and light
        # kernels), the kernel launches alone on packed weights, and the
        # plain version's same work
        with torch.no_grad():
            ms_fwd = cuda_ms(lambda: K.predictor(layers, x))
            plain_fwd = cuda_ms(lambda: K.predictor_plain(layers, x))
            res = resolve_weight_norm(layers)
            W, B = K.pack_weights([l["w"] for l in res], [l["b"] for l in res])
            xd = x.detach()
            launch_fwd = cuda_ms(lambda: K._fwd(xd, W, B, d_out))
            launch_bwd = cuda_ms(lambda: K._bwd(xd, W, B, cot))
        ms_bwd = cuda_ms_split(lambda: K.predictor(layers, x),
                               lambda o: torch.autograd.grad(o, wrt, cot))
        plain_bwd = cuda_ms_split(lambda: K.predictor_plain(layers, x),
                                  lambda o: torch.autograd.grad(o, wrt, cot))
        for d, e, ms, lms, pms, bwd, line in (
                ("fwd", err.max().item(), ms_fwd, launch_fwd, plain_fwd, False, 151),
                ("bwd", bwd_err, ms_bwd, launch_bwd, plain_bwd, True, 171)):
            b_ms, b_by = bound(K.flops(n, d_in, d_out, bwd), K.min_bytes(n, d_in, d_out, bwd))
            out.append({"name": f"predictor_{d}{sfx}", "route": "cuda",
                        "source": "nero_tpu_torch/csrc/predictor.cu",
                        "replaces": f"nero_tpu/ops/pallas/predictor_kernel.py:{line}",
                        "max_abs_err": e, "ms": ms, "launch_ms": lms, "wrapper_ms": ms,
                        "plain_ms": pms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None})
        out[-1]["mean_rel_err"] = noise_ker
        del g_p, g_k, g_b
        if not full:
            print(f"predictor{sfx}  launch fwd {launch_fwd:.3f} bwd {launch_bwd:.3f} ms, wrapper "
                  f"{ms_fwd:.3f} / {ms_bwd:.3f}, bounds {out[-2]['bound_ms']:.3f} / "
                  f"{out[-1]['bound_ms']:.3f}")
            continue
        # a ragged size (tiles of 128 rows) at the same bars, and no rows: an
        # empty output, dx, dW and dB exactly 0, nothing counted
        m = 1001
        with torch.no_grad():
            y_m, y_mp = K.predictor(layers, x[:m]), K.predictor_plain(layers, x[:m])
        err_m = (y_m - y_mp).abs()
        check(bool((err_m <= 2e-3 + 1e-2 * y_mp.abs()).all()),
              f"predictor{sfx} at n = {m}: max err {err_m.max()}")
        x_m = x[:m].detach().clone().requires_grad_(True)
        wrt_m = leaves(layers) + [x_m]
        g_p = torch.autograd.grad((K.predictor_plain(layers, x_m) * cot[:m]).sum(), wrt_m)
        g_k = torch.autograd.grad((K.predictor(layers, x_m) * cot[:m]).sum(), wrt_m)
        cos_odd = min((a.flatten() @ b.flatten() / (a.norm() * b.norm() + 1e-12)).item()
                      for a, b in zip(g_p, g_k))
        dx_odd = mean_rel(g_p[-1:], g_k[-1:])
        check(cos_odd > 0.99 and dx_odd < 0.02,
              f"predictor{sfx} at n = {m}: grads worst cosine {cos_odd}, d x {dx_odd}")
        del g_p, g_k
        counted = dict(K.launches)
        z = K._bwd(xd[:0], W, B, cot[:0])
        check(tuple(z[0].shape) == (0, d_in) and not z[1].any() and not z[2].any(),
              f"predictor_bwd{sfx} zero rows: dx {tuple(z[0].shape)}, dW or dB not zero")
        check(tuple(K._fwd(xd[:0], W, B, d_out).shape) == (0, d_out),
              f"predictor_fwd{sfx} zero rows: the output's shape")
        check(K.launches == counted,
              f"predictor{sfx} zero rows: counted a launch that was not made")
        # the backward's parts alone, on the wrapper's buffers: recompute +
        # reverse sweep, parameter pass, reduction; dx, dW and dB the same to
        # the bit in two calls
        from nero_tpu_torch.ops.cuda_build import check as check_rc, ptxas_info
        with torch.no_grad():
            first, second = (K._bwd(xd, W, B, cot) for _ in range(2))
            fwd_twice = [K._fwd(xd, W, B, d_out) for _ in range(2)]
        check(all(torch.equal(a, b) for a, b in zip(first, second)),
              f"predictor_bwd{sfx}: two calls differ")
        check(torch.equal(*fwd_twice), f"predictor_fwd{sfx}: two calls differ")
        del first, second, z, fwd_twice
        lib, stream = K._lib(), torch.cuda.current_stream(dev).cuda_stream
        di = K.padded_d_in(d_in)
        scratch, part = K.bwd_buffers(n, di, dev)
        dx_buf = torch.empty(n, d_in, device=dev)
        dW, dB = torch.empty(W.numel(), device=dev), torch.empty_like(B)
        sweep_ms = cuda_ms(lambda: check_rc(lib.predictor_bwd_sweep(
            xd.data_ptr(), n, d_in, di, d_out, W.data_ptr(), B.data_ptr(), cot.data_ptr(),
            dx_buf.data_ptr(), 1, scratch.data_ptr(), stream), "sweep"), iters=5)
        params_ms = cuda_ms(lambda: check_rc(lib.predictor_bwd_params(
            n, di, scratch.data_ptr(), part.data_ptr(), stream), "params"), iters=5)
        reduce_ms = cuda_ms(lambda: check_rc(lib.predictor_bwd_reduce(
            n, di, part.data_ptr(), dW.data_ptr(), dB.data_ptr(), stream), "reduce"), iters=5)
        buf_bytes = scratch.numel() * 2 + part.numel() * 4
        del scratch, part, dx_buf, dW, dB
        ptx = {k: ptxas_info("predictor", k) for k in
               ("predictor_bwd_sweep_kernel", "predictor_bwd_params_kernel",
                "predictor_bwd_reduce_kernel")}
        check(all(v.get("spill_bytes") == 0 for v in ptx.values()),
              f"predictor{sfx} backward spills: {ptx}")
        ptx_fwd = {"predictor_fwd_kernel": ptxas_info("predictor", "predictor_fwd_kernel")}
        check(ptx_fwd["predictor_fwd_kernel"].get("spill_bytes") == 0,
              f"predictor{sfx} forward spills: {ptx_fwd}")
        out[-2]["ptxas"] = ptx_fwd
        out[-1].update({"sweep_ms": sweep_ms, "params_ms": params_ms, "reduce_ms": reduce_ms,
                        "scratch_bytes": buf_bytes, "ptxas": ptx})
        print(f"predictor{sfx}  n = {m}: fwd max|d| {err_m.max().item():.3e}, grads worst cosine "
              f"{cos_odd:.5f}, d x {dx_odd:.3e}; n = 0: out (0, {d_out}), dx (0, {d_in}), dW and "
              f"dB zero")
        print(f"predictor_fwd{sfx}  launch {launch_fwd:.3f} ms on {-(-n // K.TILE)} tiles of "
              f"{K.TILE} rows, wrapper {ms_fwd:.3f}, bound {out[-2]['bound_ms']:.3f} ms; the same "
              f"output to the bit in two calls; predictor_fwd_kernel "
              f"{ptx_fwd['predictor_fwd_kernel'].get('regs')} regs "
              f"{ptx_fwd['predictor_fwd_kernel'].get('spill_bytes')} spill bytes")
        print(f"predictor_bwd{sfx}  launch {launch_bwd:.3f} ms = sweep {sweep_ms:.3f} + parameter "
              f"pass {params_ms:.3f} + reduction {reduce_ms:.3f}; wrapper {ms_bwd:.3f} ms, bound "
              f"{out[-1]['bound_ms']:.3f} ms; scratch + partials {buf_bytes / 1e9:.3f} GB at "
              f"N = {n}; the same dx, dW, dB to the bit in two calls; " + ", ".join(
                  f"{k} {v.get('regs')} regs {v.get('spill_bytes')} spill bytes"
                  for k, v in ptx.items()))
        torch.cuda.empty_cache()
    return out


def check_stage1_kernels(dev) -> list:
    """Every Stage-I kernel against its plain version."""
    kernels = check_sdf(N_ROWS, dev) + check_shader(N_ROWS, dev)
    for sphere, human in ((True, False), (False, True), (True, True)):
        kernels += check_shader(N_ROWS, dev, sphere, human)
    kernels += check_sdf_fwd(N_OCC_MARCH, N_SAMPLER, dev)
    kernels += check_predictor(N_ROWS, dev)
    return kernels + check_scene_kernels(dev)


def field_tracer(mesh: dict, topology: str, dev):
    """A NeuralTracer of the bowl mesh with the material model's seed, so that
    the training runs below find its field in the distill cache."""
    from nero_tpu_torch.geometry.neural_tracer import NeuralTracer
    from nero_tpu_torch.models.material import DEFAULT_MATERIAL_CFG

    t0 = time.perf_counter()
    tracer = NeuralTracer(mesh["vertices"], mesh["triangles"], verbose=False, device=dev,
                          seed=DEFAULT_MATERIAL_CFG["random_seed"], field_topology=topology)
    torch.cuda.synchronize()
    print(f"distill ({topology}): 3000 steps on 1.5 M samples (or the cached field of an "
          f"earlier run in this checkout) in {time.perf_counter() - t0:.1f} s, host signed "
          f"distances included; near-band RMS {tracer.distill_rms:.5f}")
    check(tracer.distill_rms < 0.004, f"distill RMS ({topology}) {tracer.distill_rms}")
    return tracer


def march_agreement(name: str, kernel_fn, plain_fn):
    """Kernel against plain version on the same rays: `found` agreement
    >= 0.99 and median |dt| < 1e-3 on rays both found."""
    t_k, f_k = kernel_fn()
    t_p, f_p = plain_fn()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(t_k).all()), f"{name}: non-finite t")
    agree = (f_k == f_p).float().mean().item()
    dt = (t_k - t_p).abs()[f_k & f_p]
    med, p99, mx = dt.median().item(), dt.quantile(0.99).item(), dt.max().item()
    check(agree >= 0.99, f"{name}: found agreement {agree}")
    check(med < 1e-3, f"{name}: median |dt| {med}")
    print(f"{name}: found agreement {agree:.5f} (>= 0.99)  median|dt| {med:.3e} (< 1e-3)  "
          f"p99 {p99:.3e}  max {mx:.3e} (grazing rays that bracket another crossing)  "
          f"found rate {f_k.float().mean().item():.3f}")
    return f_k, {"agree": agree, "median": med, "max": mx}


def tracer_vs_bvh(name: str, tracer, o_np, d_np, o, d, min_agree: float, max_depth_err: float,
                  min_cos: float, clear_depth: float = 0.05):
    """A device tracer against the exact host BVH on clearing rays (rays
    that miss or hit beyond `clear_depth`)."""
    _, n_c, d_c, h_c = tracer.trace_cpu(o_np, d_np)
    _, n_g, d_g, h_g = (x.cpu().numpy() for x in tracer.trace(o, d))
    clear = (~h_c) | (d_c > clear_depth)
    agree = float((h_g == h_c)[clear].mean())
    both = clear & h_c & h_g & (d_g[:, 0] > clear_depth)
    depth_err = float(np.abs(d_g[:, 0][both] - d_c[both]).mean())
    cos = float(np.sum(n_g[both] * n_c[both], -1).mean())
    print(f"{name} vs exact host BVH on {len(o_np)} surface rays: self-hit rate "
          f"{h_c.mean():.3f}, clearing-ray hit agreement {agree:.5f} (>= {min_agree}), mean "
          f"depth error {depth_err:.5f} (< {max_depth_err}), mean normal cosine {cos:.4f} "
          f"(> {min_cos})")
    check(agree >= min_agree, f"{name}: clearing-ray agreement {agree}")
    check(depth_err < max_depth_err and cos > min_cos,
          f"{name}: depth error {depth_err}, normal cosine {cos}")


def field_instance(wide: bool, any_pe: bool = False) -> str:
    """The mangled template arguments of a field kernel's instance
    (csrc/field.cuh FIELD_DISPATCH): `std` at pe 6 (PE = 6) or at any pe
    (PE = -1), `wide` (PE = -1)."""
    return "Lb1ELin1E" if wide else ("Lb0ELin1E" if any_pe else "Lb0ELi6E")


def check_field_kernels(mesh: dict, n: int, dev) -> list:
    """The three kernels of the distilled field (sphere march, uniform march,
    one evaluation) in both topologies against their plain versions, on
    fields distilled from the bowl mesh; then every tracer against the exact
    host BVH (the grid tracer is held against it where a model builds one,
    in `material_variants`)."""
    import copy

    from nero_tpu_torch.geometry.bvh import RayTracer
    from nero_tpu_torch.geometry.neural_tracer import field_apply, sphere_segment
    from nero_tpu_torch.geometry.proc_mesh import surface_rays
    from nero_tpu_torch.ops import field_fwd as KF
    from nero_tpu_torch.ops.cuda_build import ptxas_info
    from nero_tpu_torch.ops import march as KM
    from nero_tpu_torch.ops import sphere_march as K

    o_np, d_np = surface_rays(mesh, n)
    o, d = torch.as_tensor(o_np, device=dev), torch.as_tensor(d_np, device=dev)
    out, tracers = [], {}
    for topology in ("std", "wide"):
        tracer = tracers[topology] = field_tracer(mesh, topology, dev)
        sfx = "" if topology == "std" else "_wide"
        t_enter, t_exit, _ = sphere_segment(o, d, tracer.bound)
        packed = tracer.packed
        rays = (o, d, t_enter, t_exit)
        W, Fv = K.kernel_buffers(packed)
        wide = topology == "wide"

        # sphere march, both refine modes
        kw = dict(n_sphere=tracer.n_sphere, margin=tracer.margin,
                  dt_frac=1.0 / (tracer.n_coarse - 1))
        res, worst = {}, {"agree": 1.0, "median": 0.0, "max": 0.0}
        for refine, n_refine in (("illinois", 2), ("bisect", 8)):
            f_k, st = march_agreement(
                f"sphere_march{sfx}  {refine}-{n_refine}",
                lambda: K.sphere_march(packed, *rays, n_refine=n_refine, refine=refine,
                                       topology=topology, **kw),
                lambda: K.sphere_march_plain(packed, *rays, n_refine=n_refine, refine=refine,
                                             **kw))
            res[refine] = f_k
            worst = {"agree": min(worst["agree"], st["agree"]),
                     "median": max(worst["median"], st["median"]),
                     "max": max(worst["max"], st["max"])}
        check(bool((res["illinois"] == res["bisect"]).all()), "refine mode changed `found`")
        # the edges: no rays, and 1,001, not a multiple of the 16-ray warp tile
        t_0, f_0 = K.sphere_march(packed, *(x[:0] for x in rays), n_refine=2,
                                  refine="illinois", topology=topology, **kw)
        torch.cuda.synchronize()
        check(t_0.shape == f_0.shape == (0,) and t_0.dtype == torch.float32
              and f_0.dtype == torch.bool, f"sphere_march{sfx} at R = 0: {t_0}, {f_0}")
        for refine, n_refine in (("illinois", 2), ("bisect", 8)):
            ragged = tuple(x[:1001] for x in rays)
            march_agreement(
                f"sphere_march{sfx}  {refine}-{n_refine}, R = 1001",
                lambda: K.sphere_march(packed, *ragged, n_refine=n_refine, refine=refine,
                                       topology=topology, **kw),
                lambda: K.sphere_march_plain(packed, *ragged, n_refine=n_refine, refine=refine,
                                             **kw))
        args = (*rays, tracer.n_sphere, 2, True, 0.012 + 1e-6, tracer.margin, 0.9,
                kw["dt_frac"], 0.25)
        ms = cuda_ms(lambda: K._launch(W, Fv, wide, *args), iters=10)
        plain_ms = cuda_ms(lambda: K.sphere_march_plain(packed, *rays, n_refine=2,
                                                        refine="illinois", **kw),
                           iters=3, warmup=1)
        b_ms, b_by = bound(K.flops(n, tracer.n_sphere, 2, topology), K.min_bytes(n, topology))
        ptx = ptxas_info("sphere_march", rf"sphere_march_kernel\w*{field_instance(wide)}")
        check(ptx.get("spill_bytes") == 0, f"sphere_march_kernel{sfx} spills: {ptx}")
        print(f"sphere_march{sfx}: launch {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{b_ms:.3f} ms; ptxas {ptx}")
        out.append({"name": f"sphere_march{sfx}", "route": "cuda",
                    "source": "nero_tpu_torch/csrc/sphere_march.cu",
                    "replaces": "nero_tpu/ops/pallas/march_kernel.py:338",
                    "max_abs_err": worst["max"], "median_abs_err": worst["median"],
                    "found_agreement": worst["agree"], "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "ptxas": ptx})

        # uniform march: n_coarse samples, 8 bisections; on all rays, on the
        # first 1,001 (not a multiple of the 16-ray warp tile) and on none
        nc, nr = tracer.n_coarse, 8
        _, st = march_agreement(
            f"march{sfx}  c{nc}-r{nr}",
            lambda: KM.march(packed, *rays, n_coarse=nc, n_refine=nr, topology=topology),
            lambda: KM.march_plain(packed, *rays, n_coarse=nc, n_refine=nr))
        ragged = tuple(x[:1001] for x in rays)
        march_agreement(
            f"march{sfx}  c{nc}-r{nr}, R = 1001",
            lambda: KM.march(packed, *ragged, n_coarse=nc, n_refine=nr, topology=topology),
            lambda: KM.march_plain(packed, *ragged, n_coarse=nc, n_refine=nr))
        t_0, f_0 = KM.march(packed, *(x[:0] for x in rays), n_coarse=nc, n_refine=nr,
                            topology=topology)
        torch.cuda.synchronize()
        check(t_0.shape == f_0.shape == (0,) and t_0.dtype == torch.float32
              and f_0.dtype == torch.bool, f"march{sfx} at R = 0: {t_0}, {f_0}")
        ms = cuda_ms(lambda: KM._launch(W, Fv, wide, *rays, nc, nr, 0.012 + 1e-6), iters=10)
        plain_ms = cuda_ms(lambda: KM.march_plain(packed, *rays, n_coarse=nc, n_refine=nr),
                           iters=2, warmup=1)
        b_ms, b_by = bound(KM.flops(n, nc, nr, topology), K.min_bytes(n, topology))
        ptx = ptxas_info("march", rf"march_kernel\w*{field_instance(wide)}")
        check(ptx.get("spill_bytes") == 0, f"march_kernel{sfx} spills: {ptx}")
        print(f"march{sfx}: launch {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms; "
              f"ptxas {ptx}")
        out.append({"name": f"march{sfx}", "route": "cuda",
                    "source": "nero_tpu_torch/csrc/march.cu",
                    "replaces": "nero_tpu/ops/pallas/march_kernel.py:190",
                    "max_abs_err": st["max"], "median_abs_err": st["median"],
                    "found_agreement": st["agree"], "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "ptxas": ptx})

        # one evaluation per point: the points where the rays leave the surface,
        # all of them, the first 1,001 and none
        pts = (o + d * 0.02).contiguous()
        errs = []
        for m in (n, 1001):
            v_k = KF.field_fwd(packed, pts[:m], topology=topology)
            v_p = KF.field_fwd_plain(packed, pts[:m])
            with torch.no_grad():
                v_f = field_apply(tracer.field_params, pts[:m], topology=topology)
            torch.cuda.synchronize()
            e_plain = (v_k - v_p).abs().max().item()
            e_f32 = (v_k - v_f).abs().max().item()
            # the plain version rounds where the kernel does: they differ in
            # the order of the f32 sums (atol 1e-3); against the f32 field the
            # bar is tests/test_pallas_kernels.py's atol 2e-2
            check(e_plain <= 1e-3, f"field_fwd{sfx}, N = {m}: max |d| to the plain version "
                                   f"{e_plain}")
            check(e_f32 <= 2e-2, f"field_fwd{sfx}, N = {m}: max |d| to the f32 field {e_f32}")
            print(f"field_fwd{sfx}, N = {m}: max|d| to plain {e_plain:.3e} (atol 1e-3), to the "
                  f"f32 field {e_f32:.3e} (atol 2e-2)")
            errs.append((e_plain, e_f32))
        v_0 = KF.field_fwd(packed, pts[:0], topology=topology)
        torch.cuda.synchronize()
        check(v_0.shape == (0,) and v_0.dtype == torch.float32, f"field_fwd{sfx} at N = 0: {v_0}")
        ms = cuda_ms(lambda: KF._launch(W, Fv, wide, pts), iters=10)
        plain_ms = cuda_ms(lambda: KF.field_fwd_plain(packed, pts), iters=5)
        b_ms, b_by = bound(KF.flops(n, topology), KF.min_bytes(n, topology))
        ptx = ptxas_info("field_fwd", rf"field_fwd_kernel\w*{field_instance(wide)}")
        check(ptx.get("spill_bytes") == 0, f"field_fwd_kernel{sfx} spills: {ptx}")
        print(f"field_fwd{sfx}: launch {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} "
              f"ms; ptxas {ptx}")
        out.append({"name": f"field_fwd{sfx}", "route": "cuda",
                    "source": "nero_tpu_torch/csrc/field_fwd.cu",
                    "replaces": "nero_tpu/ops/pallas/field_kernel.py:90",
                    "max_abs_err": max(e for e, _ in errs),
                    "max_abs_err_f32_field": max(e for _, e in errs), "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": None, "ptxas": ptx})

    # every tracer (march + validity + normal) against the exact host BVH
    std = tracers["std"]
    tracer_vs_bvh("neural tracer (std, sphere march)", std, o_np, d_np, o, d, 0.98, 0.01, 0.95)
    uniform = copy.copy(std)
    uniform.march_mode, uniform.n_refine = "uniform", 8
    tracer_vs_bvh("neural tracer (std, uniform march c32-r8)", uniform, o_np, d_np, o, d,
                  0.98, 0.01, 0.95)
    tracer_vs_bvh("neural tracer (wide, sphere march)", tracers["wide"], o_np, d_np, o, d,
                  0.98, 0.01, 0.95)
    # the device BVH walks one node per step for all rays: a subset
    m = 16384
    bvh = RayTracer(mesh["vertices"], mesh["triangles"], device=dev)
    _, n_c, d_c, h_c = bvh.trace_cpu(o_np[:m], d_np[:m])
    _, n_g, d_g, h_g = (x.cpu().numpy() for x in bvh.trace(o[:m], d[:m]))
    same = float((h_g == h_c).mean())
    both = h_g & h_c
    depth_err = float(np.abs(d_g[:, 0] - d_c)[both].max())
    dots = float(np.sum(n_g * n_c, -1)[both].min())
    # tests/test_geometry.py:135: same hits, depth to 1e-3, normals to 0.99
    # (a ray through an edge may take either triangle: hits to 0.9999)
    print(f"device BVH vs host BVH on {m} rays: same hit {same:.6f} (>= 0.9999), max depth "
          f"error {depth_err:.2e} (< 1e-3), min normal cosine {dots:.5f}")
    check(same >= 0.9999 and depth_err < 1e-3, f"device BVH: hits {same}, depth {depth_err}")
    check(float((np.sum(n_g * n_c, -1)[both] > 0.99).mean()) >= 0.999,
          f"device BVH: normals, min cosine {dots}")
    return out


def check_lights(n: int, dev, ide_deg: int = 5, full: bool = True) -> list:
    """The light kernel, forward and backward, against its plain version at
    the full lattice, with tests/test_light_kernel.py's bars: values after
    exp to 3e-3; the gradients' worst mean error (normalised by each leaf's
    max) under 4x that of the plain version with bf16 head products + 1e-3;
    cosine > 0.99 per parameter leaf and > 0.98 for d directions (and d
    points). Mode `both` with the `direction` outer light, and mode `outer`
    with `sphere_direction`. Then a ragged n = 1001 at the same bars, n = 0
    (empty outputs, parameter gradients exactly 0), the forward's outputs and
    dW, dB and dgeo equal to the bit in two calls, the backward's sweep and
    parameter pass timed apart with their buffer bytes, and ptxas of the
    forward kernel and the backward's three (0 spill bytes); those last
    checks where `full` (the shipped build), at the IDE degree `ide_deg`."""
    from nero_tpu_torch.fields.mc_shading import MCShadingConfig, init_mc_shading
    from nero_tpu_torch.ops import lights as K
    from nero_tpu_torch.ops.mlp import exp_activation, predictor_raw

    rng = np.random.default_rng(1)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    unit = lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True)
    pts = t(rng.uniform(-0.6, 0.6, (n, 3))).requires_grad_(True)
    dirs = t(unit(rng.standard_normal((n, 3)))).requires_grad_(True)
    inters = t(rng.uniform(-0.6, 0.6, (n, 3)))
    normals = t(rng.standard_normal((n, 3)))
    cot_i, cot_o = t(rng.standard_normal((n, 3))), t(rng.standard_normal((n, 3)))
    cos = lambda a, b: (a.flatten() @ b.flatten() / (a.norm() * b.norm() + 1e-12)).item()
    out = []
    for mode, version, sfx in (("both", "direction", ""), ("outer", "sphere_direction", "_outer")):
        cfg = MCShadingConfig(human_lights=False, outer_light_version=version, ide_deg=ide_deg)
        sfx = K.counter(sfx, ide_deg)
        params = init_mc_shading(torch.Generator().manual_seed(0), cfg, device=dev)
        heads = {k: params[k] for k in ("inner_light", "outer_light")[mode == "outer":]}

        def lights(fn, m: int = n):  # the first m rows
            inner_z, outer_z = fn(params, cfg, pts[:m], dirs[:m], inters[:m], normals[:m], mode)
            return (exp_activation(inner_z, cfg.inner_light_exp_max),
                    exp_activation(outer_z, cfg.light_exp_max))

        def plain_bf16(params, cfg, pts, dirs, inters, normals, mode):
            """The plain version with the head products under bf16 autocast
            (the encodings stay f32, as in the kernel): the yardstick of
            bf16 noise."""
            x_outer = K.outer_light_input(cfg, pts, dirs)
            x_inner = K.inner_light_input(cfg, inters, -dirs, normals) if mode == "both" else None
            with torch.autocast("cuda", dtype=torch.bfloat16):
                outer_z = predictor_raw(params["outer_light"], x_outer).float()
                inner_z = (predictor_raw(params["inner_light"], x_inner).float()
                           if mode == "both" else torch.zeros_like(outer_z))
            return inner_z, outer_z

        with torch.no_grad():
            (i_k, o_k), (i_p, o_p) = lights(K.lights_raw), lights(K.lights_raw_plain)
        e_in, e_out = (i_k - i_p).abs().max().item(), (o_k - o_p).abs().max().item()
        check(e_in <= 3e-3 and e_out <= 3e-3, f"lights{sfx}: inner {e_in} outer {e_out}")
        if mode == "outer":
            check(float(i_k.max()) == 1.0 and float(i_k.min()) == 1.0, "outer mode: inner_z != 0")
        print(f"lights_fwd{sfx}    max|d inner| {e_in:.3e}  max|d outer| {e_out:.3e} "
              f"(after exp, atol 3e-3)")

        def loss(fn, m: int = n):
            inner, outer = lights(fn, m)
            return (inner * cot_i[:m]).sum() + (outer * cot_o[:m]).sum()

        wrt = leaves(heads) + [dirs] + ([pts] if version == "sphere_direction" else [])
        n_par = len(leaves(heads))
        g_p = torch.autograd.grad(loss(K.lights_raw_plain), wrt)
        g_k = torch.autograd.grad(loss(K.lights_raw), wrt)
        g_b = torch.autograd.grad(loss(plain_bf16), wrt)
        mean_rel = lambda ga, gb: max(((a - b).abs().mean() / (a.abs().max() + 1e-8)).item()
                                      for a, b in zip(ga, gb))
        noise_ker, noise_bf16 = mean_rel(g_p, g_k), mean_rel(g_p, g_b)
        cos_par = min(cos(a, b) for a, b in zip(g_p[:n_par], g_k[:n_par]))
        cos_geo = min(cos(a, b) for a, b in zip(g_p[n_par:], g_k[n_par:]))
        check(noise_ker < 4.0 * noise_bf16 + 1e-3,
              f"lights{sfx} grads: {noise_ker} vs bf16 {noise_bf16}")
        check(cos_par > 0.99, f"lights{sfx} grads: worst parameter cosine {cos_par}")
        check(cos_geo > 0.98, f"lights{sfx} grads: d dirs / d points cosine {cos_geo}")
        bwd_err = grad_err_normalised(g_p, g_k)
        print(f"lights_bwd{sfx}    worst parameter cosine {cos_par:.5f} (> 0.99)  d dirs"
              f"{' / d points' if len(wrt) > n_par + 1 else ''} cosine {cos_geo:.5f} (> 0.98)  "
              f"worst mean|d|/max|g| {noise_ker:.3e} (< 4 x bf16 {noise_bf16:.3e} + 1e-3)  "
              f"worst max|d|/max|g| {bwd_err:.3e} (bf16 plain: "
              f"{grad_err_normalised(g_p, g_b):.3e})")

        call = lambda fn: torch.cat(fn(params, cfg, pts, dirs, inters, normals, mode), -1)
        gout = t(rng.standard_normal((n, 6)))
        with torch.no_grad():
            ms_fwd = cuda_ms(lambda: call(K.lights_raw))
            plain_fwd = cuda_ms(lambda: call(K.lights_raw_plain), iters=5)
            # the launches alone, on packed weights
            geo, sphere, both, ws, bs = K.kernel_inputs(params, cfg, pts, dirs, inters, normals,
                                                        mode)
            W, B = K.pack_buffers(ws, bs, sphere, both, ide_deg)
            launch_fwd = cuda_ms(lambda: K._fwd(geo, W, B, sphere, both, ide_deg))
            launch_bwd = cuda_ms(lambda: K._bwd(geo, W, B, sphere, both, gout, ide_deg))
        ms_bwd = cuda_ms_split(lambda: call(K.lights_raw),
                               lambda o: torch.autograd.grad(o, wrt, gout))
        plain_bwd = cuda_ms_split(lambda: call(K.lights_raw_plain),
                                  lambda o: torch.autograd.grad(o, wrt, gout))
        for name, err, ms, lms, pms, bwd, line in (
                (f"lights_fwd{sfx}", max(e_in, e_out), ms_fwd, launch_fwd, plain_fwd, False, 231),
                (f"lights_bwd{sfx}", bwd_err, ms_bwd, launch_bwd, plain_bwd, True, 259)):
            b_ms, b_by = bound(K.flops(n, cfg, mode, bwd), K.min_bytes(n, cfg, mode, bwd))
            out.append({"name": name, "route": "cuda",
                        "source": "nero_tpu_torch/csrc/lights.cu",
                        "replaces": f"nero_tpu/ops/pallas/light_kernel.py:{line}",
                        "max_abs_err": err, "ms": ms, "launch_ms": lms, "wrapper_ms": ms,
                        "plain_ms": pms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None})
        out[-1]["mean_rel_err"] = noise_ker
        del g_p, g_k, g_b
        if not full:  # the build's registers and spills, reported
            from nero_tpu_torch.ops.cuda_build import ptxas_info
            inst = f"\\w*Lb{int(sphere)}ELb{int(both)}E"
            for row, kern in zip(out[-2:], ("lights_fwd_kernel", "lights_bwd_sweep_kernel")):
                row["ptxas"] = {kern: ptxas_info("lights", kern + inst, K.defines(ide_deg))}
            print(f"lights{sfx}    launch fwd {launch_fwd:.3f} bwd {launch_bwd:.3f} ms, wrapper "
                  f"{ms_fwd:.3f} / {ms_bwd:.3f}, bounds {out[-2]['bound_ms']:.3f} / "
                  f"{out[-1]['bound_ms']:.3f}; ptxas {out[-2]['ptxas']} {out[-1]['ptxas']}")
            torch.cuda.empty_cache()
            continue
        # a ragged size (tiles of 128 rows) at the same bars, and no rows:
        # empty outputs, parameter gradients exactly 0
        m = 1001
        with torch.no_grad():
            (i_k, o_k), (i_p, o_p) = lights(K.lights_raw, m), lights(K.lights_raw_plain, m)
        e_odd = max((i_k - i_p).abs().max().item(), (o_k - o_p).abs().max().item())
        g_p = torch.autograd.grad(loss(K.lights_raw_plain, m), wrt)
        g_k = torch.autograd.grad(loss(K.lights_raw, m), wrt)
        cos_odd = (min(cos(a, b) for a, b in zip(g_p[:n_par], g_k[:n_par])),
                   min(cos(a, b) for a, b in zip(g_p[n_par:], g_k[n_par:])))
        check(e_odd <= 3e-3 and cos_odd[0] > 0.99 and cos_odd[1] > 0.98,
              f"lights{sfx} at n = {m}: max err {e_odd}, cosines {cos_odd}")
        counted = dict(K.launches)
        i_0, o_0 = lights(K.lights_raw, 0)
        check(tuple(i_0.shape) == (0, 3) and tuple(o_0.shape) == (0, 3),
              f"lights{sfx} zero rows: shapes {tuple(i_0.shape)}, {tuple(o_0.shape)}")
        g_0 = torch.autograd.grad(loss(K.lights_raw, 0), leaves(heads))
        check(all(not g.any() for g in g_0), f"lights{sfx} zero rows: non-zero parameter gradients")
        check(K.launches == counted, f"lights{sfx} zero rows: counted a launch that was not made")
        print(f"lights_bwd{sfx}    n = {m}: max|d lights| {e_odd:.3e}, worst cosine parameters "
              f"{cos_odd[0]:.5f} geometry {cos_odd[1]:.5f}; n = 0: shapes (0,3) (0,3), parameter "
              f"gradients zero")
        del g_p, g_k
        # the backward's parts alone, on the wrapper's buffers: recompute +
        # reverse sweep, then the weight- and bias-gradient pass with its
        # reduction; the same outputs and gradients to the bit in two calls;
        # no rows, no launch, zeros
        from nero_tpu_torch.ops.cuda_build import check as check_rc, ptxas_info
        with torch.no_grad():
            check(torch.equal(K._fwd(geo, W, B, sphere, both), K._fwd(geo, W, B, sphere, both)),
                  f"lights_fwd{sfx}: two calls differ")
            first, second = (K._bwd(geo, W, B, sphere, both, gout) for _ in range(2))
        check(all(torch.equal(a, b) for a, b in zip(first, second)),
              f"lights_bwd{sfx}: two calls differ")
        z = K._bwd(geo[:0], W, B, sphere, both, gout[:0])
        check(not z[1].any() and not z[2].any(), f"lights_bwd{sfx} zero rows: dW or dB not zero")
        del first, second, z
        lib, stream = K._lib(), torch.cuda.current_stream(dev).cuda_stream
        scratch, part = K.bwd_buffers(n, sphere, both, dev)
        dgeo6 = torch.empty(n, 6, device=dev)
        dW, dB = torch.empty(W.numel(), device=dev), torch.empty_like(B)
        tab = K.ide_table_on(dev)
        sweep_ms = cuda_ms(lambda: check_rc(lib.lights_bwd_sweep(
            geo.data_ptr(), n, W.data_ptr(), B.data_ptr(), tab.data_ptr(), int(sphere),
            int(both), gout.data_ptr(), dgeo6.data_ptr(), scratch.data_ptr(), stream), "sweep"),
            iters=5)
        params_ms = cuda_ms(lambda: check_rc(lib.lights_bwd_params(
            n, int(sphere), int(both), scratch.data_ptr(), part.data_ptr(), dW.data_ptr(),
            dB.data_ptr(), stream), "params"), iters=5)
        buf_bytes = scratch.numel() * 2 + part.numel() * 4
        del scratch, part, dgeo6, dW, dB
        inst = f"\\w*Lb{int(sphere)}ELb{int(both)}E"  # the variant's template instance
        ptx = {k: ptxas_info("lights", k + inst) for k in
               ("lights_fwd_kernel", "lights_bwd_sweep_kernel", "lights_bwd_params_kernel",
                "lights_bwd_reduce_kernel")}
        check(all(v.get("spill_bytes") == 0 for v in ptx.values()), f"lights{sfx} spills: {ptx}")
        out[-2]["ptxas"] = {"lights_fwd_kernel": ptx.pop("lights_fwd_kernel")}
        out[-1].update({"sweep_ms": sweep_ms, "params_ms": params_ms, "scratch_bytes": buf_bytes,
                        "ptxas": ptx})
        print(f"lights_fwd{sfx}    launch {launch_fwd:.3f} ms on {-(-n // K.TILE)} tiles of "
              f"{K.TILE} rows, wrapper {ms_fwd:.3f}; the same outputs to the bit in two calls; "
              f"lights_fwd_kernel {out[-2]['ptxas']['lights_fwd_kernel'].get('regs')} regs "
              f"{out[-2]['ptxas']['lights_fwd_kernel'].get('spill_bytes')} spill bytes")
        print(f"lights_bwd{sfx}    launch {launch_bwd:.3f} ms = recompute + sweep {sweep_ms:.3f} + "
              f"parameter pass {params_ms:.3f}; scratch + partials {buf_bytes / 1e9:.3f} GB at "
              f"N = {n}; the same dW, dB, dgeo to the bit in two calls; " + ", ".join(
                  f"{k} {v.get('regs')} regs {v.get('spill_bytes')} spill bytes"
                  for k, v in ptx.items()))
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def reset_launches():
    from nero_tpu_torch.core.mfu import kernel_modules
    for m in kernel_modules():
        for k in m.launches:
            m.launches[k] = 0


def read_launches() -> dict:
    from nero_tpu_torch.core.mfu import launch_counts
    return launch_counts()


def expect_launches(**counts) -> dict:
    """Every counter at 0 but the named ones."""
    return {**{k: 0 for k in read_launches()}, **counts}


def shape_cfg(cfg_file: str, root: str, shader_over=None, **over) -> dict:
    """configs/shape/proc/<cfg_file> with the output dirs in `root`; `over`
    replaces further keys, `shader_over` keys of shader_config."""
    from nero_tpu_torch.core.config import load_cfg

    cfg = load_cfg(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "configs", "shape", "proc", cfg_file))
    cfg.update(model_root=root, vis_dir=root, **over)
    cfg["shader_config"] = {**cfg.get("shader_config", {}), **(shader_over or {})}
    return cfg


def stage1_expect(scfg, steps: int, val_chunks: int = 0, occ_steps: int = 0) -> dict:
    """Launches of `steps` Stage-I training steps (`occ_steps` of them at or
    past occ_loss_step) and `val_chunks` validation chunks, for a config as
    the model resolved it. A step runs the SDF-with-gradient kernel (with
    sdf_grad_mode `fused`) and the shader once each way (the shader's
    forward twice with remat_shader): the whole-shader kernel of the config's
    variant, or head by head (the outer-light head twice) through the
    predictor kernel. A validation chunk runs both forwards twice (render,
    then the validation maps). With use_fused_sdf the sampler launches the
    value-only SDF kernel once per up-sample round and every occlusion march
    (one per occ step, one per validation chunk) twice."""
    from nero_tpu_torch.fields.app_shading import fused_shader_active
    from nero_tpu_torch.ops import sdf_grad as KG
    from nero_tpu_torch.ops import shader as KS

    sh = scfg.shader
    fwd = (2 if scfg.remat_shader else 1) * steps + 2 * val_chunks
    e = {}
    m = scfg.sdf_freq  # another multires than 6 counts under its own names
    if scfg.sdf_grad_mode == "fused":
        e[KG.counter("sdf_grad_fwd", m)] = steps + 2 * val_chunks
        e[KG.counter("sdf_grad_bwd", m)] = steps
    if fused_shader_active(sh, torch.bfloat16 if scfg.bf16_hidden else torch.float32):
        e["shader_fwd" + KS.variant(sh)] = fwd
        e["shader_bwd" + KS.variant(sh)] = steps
    elif sh.fused_heads:
        for name, (d_in, d_out) in KS.head_dims(sh).items():
            evals = 2 if name == "outer_light" else 1
            for d, count in (("fwd", fwd), ("bwd", steps)):
                key = f"predictor_{d}_{d_in}x{d_out}"
                e[key] = e.get(key, 0) + evals * count
    if scfg.use_fused_sdf:
        e[KG.counter("sdf_fwd", m)] = (scfg.up_sample_steps * (steps + val_chunks)
                                       + 2 * (occ_steps + val_chunks))
    return expect_launches(**e)


def stage1_val_chunks(model) -> int:
    """Ray chunks of one validation pass of a shape model."""
    h, w = model.test_imgs_info["imgs"].shape[1:3]
    ratio = model.cfg["downsample_ratio"]
    rays = int(ratio * h) * int(ratio * w) * len(model.test_ids)
    return -(-rays // model.cfg["test_ray_num"])


def material_val_chunks(model) -> int:
    """Chunks of test_ray_num hit pixels of one validation pass of a
    material model (one march launch each)."""
    info = model.test_imgs_info
    h, w = info["imgs"].shape[1:3]
    chunks = 0
    for i in range(len(model.test_ids)):
        hit = model.ray_tracer.trace_cpu(*model._image_rays_np(info["Ks"][i], info["poses"][i],
                                                               h, w))[3]
        chunks += -(-int(hit.sum()) // model.cfg["test_ray_num"])
    return chunks


def train(cfg_file: str, steps: int, dev, cfg: dict | None = None,
          keep_trainer: bool = False) -> dict:
    """Stage I through Trainer at full width: `steps` steps and one
    validation view, then one step at occ_loss_step. `cfg_file` names a
    config of configs/shape/proc, or labels `cfg`, a config given whole.
    `keep_trainer`: the result holds the Trainer too."""
    from nero_tpu_torch.render.rays import sample_ray_batch
    from nero_tpu_torch.train.trainer import Trainer

    root = tempfile.mkdtemp(prefix="nero_smoke_")
    over = dict(total_step=steps, val_interval=steps, save_interval=10 * steps, train_log_step=1)
    cfg = shape_cfg(cfg_file, root, **over) if cfg is None else \
        {**cfg, "model_root": root, "vis_dir": root, **over}
    trainer = Trainer(cfg, device=dev)
    trainer.setup()
    model = trainer.model
    tag = f"train ({cfg_file})"
    # a held-out batch, the same before and after training (no perturbation)
    d = model.train_data
    fixed = sample_ray_batch(torch.Generator(device=dev).manual_seed(7), d["imgs_u8"],
                             d["K_inv"], d["poses"], model.cfg["train_ray_num"],
                             d["human_poses"])

    def fixed_loss_rgb() -> float:
        with torch.no_grad():
            _, log = model.loss_fn(model.params, fixed, 0, gen=None)
        return float(log["loss_rgb"].mean())

    before = fixed_loss_rgb()
    reset_launches()
    trainer.run()
    torch.cuda.synchronize()
    launches = read_launches()

    hist = trainer.train_history
    for h in hist:
        for k, v in h.items():
            check(math.isfinite(v), f"{tag} step {h['step']}: {k} = {v}")
    rgb = [h["loss_rgb"] for h in hist]
    after = fixed_loss_rgb()
    check(after < before, f"{tag}: loss_rgb on a held-out batch did not fall: {before} -> {after}")
    val = trainer.val_results
    check(all(math.isfinite(v) for v in val.values()), f"{tag} validation: {val}")

    chunks = stage1_val_chunks(model)
    expect = stage1_expect(model.scfg, steps, val_chunks=chunks)
    check(launches == expect, f"{tag} launches {nonzero(launches)}, expected {nonzero(expect)}")

    # the occlusion-loss branch, one step at occ_loss_step
    reset_launches()
    log = trainer.train_step(model.scfg.occ_loss_step)
    occ = {k: float(v) for k, v in log.items()}
    check(all(math.isfinite(v) for v in occ.values()), f"{tag} occ step: {occ}")
    occ_launches = read_launches()
    expect = stage1_expect(model.scfg, 1, occ_steps=1)
    check(occ_launches == expect,
          f"{tag} occ step launches {nonzero(occ_launches)}, expected {nonzero(expect)}")

    step_s = float(np.median([x["step_seconds"] for x in hist[2:]]))
    print(f"{tag}: {steps} steps, held-out loss_rgb {before:.5f} -> {after:.5f}, "
          f"per-step loss_rgb {rgb[0]:.4f} -> {rgb[-1]:.4f}, "
          f"val psnr {val.get('val-psnr', float('nan')):.3f}, occ-step loss_occ "
          f"{occ.get('loss_occ', float('nan')):.5f}")
    print(f"{tag}: step {step_s * 1e3:.2f} ms (median, host clock after synchronize), "
          f"{model.num_train_rays_per_step() / step_s:.1f} rays/s")
    print(f"{tag}: launches over the run {nonzero(launches)} = {steps} steps + {chunks} "
          f"validation chunk(s); occ step {nonzero(occ_launches)}")
    total = {k: launches.get(k, 0) + occ_launches.get(k, 0) for k in {**launches, **occ_launches}}
    return {"launches": total, "held_out": after, "loss_rgb": rgb, "step_ms": step_s * 1e3,
            "mfu": mfu_record(cfg_file, trainer), **({"trainer": trainer} if keep_trainer else {})}


def timed_steps(trainer, first: int, last: int, tag: str) -> tuple[list, list]:
    """Steps [first, last) through Trainer.train_step, each synchronised:
    (per-step logs as floats, per-step seconds); every loss finite."""
    logs, times = [], []
    for step in range(first, last):
        t0 = synced()
        log = {k: float(v) for k, v in trainer.train_step(step).items()}
        times.append(synced() - t0)
        check(all(math.isfinite(v) for v in log.values()), f"{tag} step {step}: {log}")
        logs.append(log)
    return logs, times


def short_shape_run(label: str, steps: int, dev, cfg_file: str = "sphere.yaml",
                    start_step: int = 0, shader_over=None, **cfg_over) -> dict:
    """A few Stage-I steps of a variant of a sphere config through
    Trainer.train_step, from `start_step`: finite losses and exactly the
    expected launches. Returns the launches and the median step time."""
    from nero_tpu_torch.train.trainer import Trainer

    root = tempfile.mkdtemp(prefix="nero_smoke_shape2_")
    trainer = Trainer(shape_cfg(cfg_file, root, shader_over, total_step=start_step + steps,
                                **cfg_over), device=dev)
    trainer.setup()
    model = trainer.model
    reset_launches()
    logs, times = timed_steps(trainer, start_step, start_step + steps, label)
    log = logs[-1]
    launches = read_launches()
    occ_steps = sum(s >= model.scfg.occ_loss_step for s in range(start_step, start_step + steps))
    want = stage1_expect(model.scfg, steps, occ_steps=occ_steps)
    check(launches == want, f"{label} launches {nonzero(launches)}, expected {nonzero(want)}")
    step_ms = float(np.median(times[1:])) * 1e3
    print(f"shape ({label}): {steps} steps from step {start_step}, last loss_rgb "
          f"{log['loss_rgb']:.4f}, loss_occ {log.get('loss_occ', float('nan')):.5f}, step "
          f"{step_ms:.2f} ms (median after the first), launches {nonzero(launches)}")
    return {"launches": launches, "step_ms": step_ms}


def shape_variants(dev) -> list:
    """Short runs of every other Stage-I switch, each with its launches
    asserted; the human light is timed through both shader paths."""
    occ = 20000   # occ_loss_step of the sphere configs
    runs = [
        short_shape_run("sphere_direction", 4, dev, shader_over={"sphere_direction": True}),
        short_shape_run("sphere_direction + human_light", 4, dev, "sphere_real.yaml",
                        shader_over={"sphere_direction": True}),
        short_shape_run("shade_top_k 32 past occ_loss_step", 4, dev, start_step=occ - 1,
                        shade_top_k=32),
        short_shape_run("bg_on_inner", 3, dev, bg_on_inner=True),
        short_shape_run("remat_shader", 3, dev, remat_shader=True),
    ]
    kernel_path = short_shape_run("human_light, whole-shader kernel", 5, dev, "sphere_real.yaml")
    per_head = short_shape_run("human_light, fused_shader false (tensor-op heads)", 5, dev,
                               "sphere_real.yaml", shader_over={"fused_shader": False})
    heads_kernel = short_shape_run(
        "human_light + sphere_direction, fused_shader false, fused_heads", 5, dev,
        "sphere_real.yaml", shader_over={"fused_shader": False, "fused_heads": True,
                                         "sphere_direction": True})
    print(f"human_light step: whole-shader kernel {kernel_path['step_ms']:.2f} ms, per-head "
          f"tensor ops {per_head['step_ms']:.2f} ms, per-head predictor kernel (with "
          f"sphere_direction) {heads_kernel['step_ms']:.2f} ms")
    return [r["launches"] for r in runs + [kernel_path, per_head, heads_kernel]]


def nonzero(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


def material_cfg(mesh: dict, root: str, cfg_file: str = "bowl.yaml", shader_over=None,
                 **over) -> dict:
    """configs/material/proc/<cfg_file> with the mesh written to `root` and
    the output dirs there; `over` replaces further keys, `shader_over` keys
    of shader_cfg."""
    from nero_tpu_torch.core.config import load_cfg
    from nero_tpu_torch.geometry.mesh_io import write_ply

    cfg = load_cfg(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "configs", "material", "proc", cfg_file))
    mesh_fn = os.path.join(root, f"mesh_{len(mesh['vertices'])}.ply")
    write_ply(mesh_fn, mesh["vertices"], mesh["triangles"])
    cfg.update(mesh=mesh_fn, model_root=root, vis_dir=root, **over)
    cfg["shader_cfg"] = {**cfg["shader_cfg"], **(shader_over or {})}
    return cfg


def train_material(mesh: dict, steps: int, dev, cfg_file: str, fused: bool,
                   keep_trainer: bool = False) -> dict:
    """Stage II on the bowl scene at the published width, through Trainer:
    `steps` steps and one validation view. Returns the launches, the run's
    MFU record, the step median and (`keep_trainer`) the Trainer."""
    from nero_tpu_torch.render.shape import compute_rgb_loss
    from nero_tpu_torch.train.trainer import Trainer

    root = tempfile.mkdtemp(prefix="nero_smoke_mat_")
    cfg = material_cfg(mesh, root, cfg_file, total_step=steps, val_interval=steps,
                       save_interval=10 * steps, train_log_step=1)
    trainer = Trainer(cfg, device=dev)
    trainer.setup()
    model = trainer.model
    tag = f"material ({cfg_file})"
    print(f"{tag}: {model.tbn} hit pixels in the store, distill RMS "
          f"{model.ray_tracer.distill_rms:.5f}, inner_compact_frac "
          f"{model.mcfg.inner_compact_frac:.3f}, outer_compact_frac "
          f"{model.mcfg.outer_compact_frac:.3f}, fused_lights {model.mcfg.fused_lights}")
    check(bool(model.mcfg.fused_lights) == fused, f"{tag}: fused_lights {model.mcfg}")
    # a held-out batch, shaded on the fixed direction lattice (no azimuth
    # rotation), the same before and after training
    fixed = model.sample_batch(torch.Generator(device=dev).manual_seed(7))

    def fixed_loss_rgb() -> float:
        with torch.no_grad():
            colors, _ = model.shade(model.params, fixed, gen=None)
        return float(compute_rgb_loss(colors, fixed["rgb"], model.cfg["rgb_loss"]).mean())

    before = fixed_loss_rgb()
    reset_launches()
    trainer.run()
    torch.cuda.synchronize()
    launches = read_launches()
    after = fixed_loss_rgb()

    hist = trainer.train_history
    check(len(hist) == steps, f"{len(hist)} logged steps")
    for h in hist:
        for k in ("loss_rgb", "loss_mat_reg", "loss_diffuse_light", "loss_total"):
            check(math.isfinite(h[k]), f"{tag} step {h['step']}: {k} = {h[k]}")
    check(after < before, f"{tag}: loss_rgb on a held-out batch did not fall: "
                          f"{before} -> {after}")
    val = trainer.val_results
    check(all(math.isfinite(v) for v in val.values()), f"{tag} validation: {val}")

    # one validation view: per chunk of its hit pixels one march launch and,
    # fused, one forward of the light kernel
    chunks = material_val_chunks(model)
    expect = expect_launches(sphere_march=steps + chunks)
    if fused:  # another IDE degree than 5 counts under its own names
        from nero_tpu_torch.ops.lights import counter
        deg = model.mcfg.ide_deg
        expect.update({counter("lights_fwd", deg): steps + chunks,
                       counter("lights_bwd", deg): steps})
    check(launches == expect, f"{tag} launches {nonzero(launches)}, expected {nonzero(expect)}")

    step_s = float(np.median([x["step_seconds"] for x in hist[2:]]))
    print(f"{tag}: {steps} steps, held-out loss_rgb {before:.6f} -> {after:.6f}, per-step "
          f"loss_rgb {hist[0]['loss_rgb']:.4f} -> {hist[-1]['loss_rgb']:.4f}, val psnr "
          f"{val.get('val-psnr', float('nan')):.3f}")
    print(f"{tag}: step {step_s * 1e3:.2f} ms (median, host clock after synchronize), "
          f"{model.num_train_rays_per_step() / step_s:.1f} points/s; launches "
          f"{nonzero(launches)} = {steps} steps + {chunks} validation chunks")
    return {"launches": launches, "mfu": mfu_record(cfg_file, trainer), "step_ms": step_s * 1e3,
            **({"trainer": trainer} if keep_trainer else {})}


def short_material_run(label: str, mesh: dict, steps: int, dev, expect: dict, regime=None,
                       **cfg_over) -> dict:
    """A few Stage-II steps of a variant of the bowl config through
    Trainer.train_step: finite losses and exactly the expected launches."""
    from nero_tpu_torch.train.trainer import Trainer

    root = tempfile.mkdtemp(prefix="nero_smoke_mat2_")
    trainer = Trainer(material_cfg(mesh, root, total_step=steps, **cfg_over), device=dev)
    trainer.setup()
    model = trainer.model
    if regime is not None:
        regime(model)
    reset_launches()
    log = timed_steps(trainer, 0, steps, label)[0][-1]
    launches = read_launches()
    want = expect_launches(**expect)
    check(launches == want, f"{label} launches {nonzero(launches)}, expected {nonzero(want)}")
    print(f"material ({label}): {steps} steps, tracer {type(model.ray_tracer).__name__}, "
          f"inner_compact_frac {model.mcfg.inner_compact_frac:.3f}, last loss_rgb "
          f"{log['loss_rgb']:.4f}, launches {nonzero(launches)}")
    return launches


def material_variants(bowl: dict, dev) -> list:
    """Short runs of every Stage-II switch, each with its launches asserted:
    the convex regime (human light, sphere_direction, inner compaction on)
    unfused and fused, the uniform march, the wide field under both marches,
    and the grid tracer."""
    from nero_tpu_torch.geometry.grid_tracer import GridTracer
    from nero_tpu_torch.geometry.proc_mesh import proc_mesh, surface_rays

    sphere = proc_mesh("sphere")
    convex = dict(database_name="proc/sphere/100_12", name="proc_sphere_material")
    convex_shader = {"human_lights": True, "outer_light_version": "sphere_direction"}

    def convex_regime(model):
        check(model.mcfg.inner_compact_frac > 0.0 and model.mcfg.outer_compact_frac == 0.0,
              f"convex regime: compaction {model.mcfg}")

    def grid_tracer(model):
        # the model's own grid tracer (256^3, baked on the host at set-up)
        # against the exact host BVH, with tests/test_grid_tracer.py's bars:
        # hits > 0.9, depth of non-grazing hits (beyond 0.1) to 0.03,
        # normals to 0.85
        check(isinstance(model.ray_tracer, GridTracer), f"tracer {type(model.ray_tracer)}")
        o_np, d_np = surface_rays(bowl, N_MARCH_RAYS)
        o, d = torch.as_tensor(o_np, device=dev), torch.as_tensor(d_np, device=dev)
        tracer_vs_bvh("grid tracer", model.ray_tracer, o_np, d_np, o, d, 0.9, 0.03, 0.85,
                      clear_depth=0.1)

    return [
        short_material_run("convex, human light, sphere_direction", sphere, 5, dev,
                           dict(sphere_march=5), convex_regime, shader_over=convex_shader,
                           **convex),
        short_material_run("convex, fused lights: outer head only", sphere, 5, dev,
                           dict(sphere_march=5, lights_fwd_outer=5, lights_bwd_outer=5),
                           convex_regime,
                           shader_over={**convex_shader, "fused_lights": True}, **convex),
        short_material_run("uniform march", bowl, 5, dev, dict(march=5),
                           tracer_march_mode="uniform", tracer_n_refine=8),
        short_material_run("wide field", bowl, 5, dev, dict(sphere_march_wide=5),
                           tracer_field_topology="wide"),
        short_material_run("wide field, uniform march", bowl, 3, dev, dict(march_wide=3),
                           tracer_field_topology="wide", tracer_march_mode="uniform",
                           tracer_n_refine=8),
        short_material_run("grid tracer", bowl, 3, dev, {}, grid_tracer, tracer="grid"),
    ]

# ---------------------------------------------------------------------------
# phase 7: the whole chain, Stage I -> mesh -> Stage II -> materials
# ---------------------------------------------------------------------------

CHAIN_STEPS = 300        # Stage I of the chain (sphere.yaml)
CHAIN_MESH_RES = 512     # the extraction grid, as extract_mesh.py's default
CHAIN_PARITY_RES = 64    # the grid evaluated on the card and on the CPU
CHAIN_PARITY_TOL = 1e-4  # max |grid difference| between them
CHAIN_EVAL_DB = "proc/sphere/128_16"    # the scene Stage I trained on
CHAIN_DENSE_DB = "proc/sphere/256_24"   # a denser view set for the Chamfer figure
CHAIN_DENSE_VOXEL = 0.005
CHAIN_STAGE2_STEPS = 5
CHAIN_TEXTURE_RES = 1024


def write_cfg(cfg: dict, path: str) -> str:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def chain(dev) -> list:
    """What a NeRO user runs after training, on a Stage-I model of the
    port's own: `sphere.yaml` trained CHAIN_STEPS steps, its mesh at
    CHAIN_MESH_RES^3 (`extract_mesh`), the same grid on the card and on the
    CPU at CHAIN_PARITY_RES^3, the Chamfer evaluation (`eval_synthetic_shape`,
    and the distance to a denser cloud with the mesh's error against the
    scene's analytic SDF), Stage II (`bowl.yaml`'s shader, losses and
    trainer) on that mesh through the neural tracer, then the per-vertex
    materials and the texture maps. Returns the launches of both trainings."""
    from nero_tpu_torch import (eval_synthetic_shape, extract_materials,
                                extract_materials_texture_map, extract_mesh)
    from nero_tpu_torch.core.checkpoint import load_checkpoint
    from nero_tpu_torch.dataset.database import get_database_eval_points, parse_database_name
    from nero_tpu_torch.dataset.synthetic import scene_sdf
    from nero_tpu_torch.fields.sdf import sdf_value
    from nero_tpu_torch.geometry.chamfer import chamfer_distance
    from nero_tpu_torch.geometry.isosurface import extract_fields
    from nero_tpu_torch.models.shape import NeROShapeModel
    from nero_tpu_torch.train.trainer import Trainer

    root = tempfile.mkdtemp(prefix="nero_smoke_chain_")
    tag = "chain"

    # Stage I, checkpoint saved at the end
    cfg1 = shape_cfg("sphere.yaml", root, total_step=CHAIN_STEPS, val_interval=CHAIN_STEPS,
                     save_interval=10 * CHAIN_STEPS, train_log_step=10)
    cfg1_fn = write_cfg(cfg1, os.path.join(root, "shape.yaml"))
    trainer = Trainer(cfg1, device=dev)
    trainer.setup()
    reset_launches()
    t0 = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    stage1_s = time.perf_counter() - t0
    stage1 = read_launches()
    for h in trainer.train_history:
        check(all(math.isfinite(v) for v in h.values()), f"{tag} Stage I step {h['step']}: {h}")
    want = stage1_expect(trainer.model.scfg, CHAIN_STEPS,
                         val_chunks=stage1_val_chunks(trainer.model))
    check(stage1 == want, f"{tag} Stage I launches {nonzero(stage1)}, expected {nonzero(want)}")
    hist = trainer.train_history
    step_ms = float(np.median([h["step_seconds"] for h in hist[2:]])) * 1e3
    print(f"{tag}: Stage I {CHAIN_STEPS} steps of sphere.yaml in {stage1_s:.1f} s (step "
          f"{step_ms:.2f} ms, median), loss_rgb {hist[0]['loss_rgb']:.4f} -> "
          f"{hist[-1]['loss_rgb']:.4f}, val psnr "
          f"{trainer.val_results.get('val-psnr', float('nan')):.3f}; launches {nonzero(stage1)}")

    # the mesh; extraction and evaluation launch no kernel of the port (the
    # grid's SDF values and the Chamfer product are plain torch, as they are
    # XLA outside any Pallas kernel in the JAX package)
    reset_launches()
    on = ["--device", dev.type]
    mesh = extract_mesh.main(["--cfg", cfg1_fn, "--resolution", str(CHAIN_MESH_RES),
                              "--output_dir", os.path.join(root, "meshes")] + on)
    verts, tris = mesh["vertices"], mesh["triangles"]
    radius = float(np.median(np.linalg.norm(verts, axis=-1)))
    check(len(verts) > 100 and np.isfinite(verts).all() and 0.2 < radius < 0.9,
          f"{tag} mesh: {len(verts)} vertices, median radius {radius}")
    print(f"{tag}: mesh at {CHAIN_MESH_RES}^3: {len(verts)} vertices, {len(tris)} triangles, "
          f"median radius {radius:.5f}; grid evaluation on the card "
          f"({CHAIN_MESH_RES ** 3} points in {-(-CHAIN_MESH_RES ** 3 // 262144)} chunks) "
          f"{mesh['grid_seconds']:.3f} s, host iso-surface {mesh['surface_seconds']:.3f} s")

    # the same checkpoint's grid on the card and on the CPU
    grids = []
    for d in (dev, torch.device("cpu")):
        model = NeROShapeModel(cfg1, training=False, device=d)
        load_checkpoint(os.path.join(root, cfg1["name"], "model.npz"), model.params)
        sdf_params, sdf_cfg = model.params["sdf"], model.scfg.sdf_cfg
        grids.append(extract_fields([-1.01] * 3, [1.01] * 3, CHAIN_PARITY_RES,
                                    lambda p: sdf_value(sdf_params, p, sdf_cfg), device=d))
    grid_err = float(np.abs(grids[0] - grids[1]).max())
    print(f"{tag}: {CHAIN_PARITY_RES}^3 grid, card against CPU: max |diff| {grid_err:.3e} "
          f"(<= {CHAIN_PARITY_TOL})")
    check(grid_err <= CHAIN_PARITY_TOL, f"{tag}: card grid against CPU grid {grid_err}")

    # Chamfer: the evaluator, then a denser cloud and the analytic SDF
    t0 = time.perf_counter()
    ev = eval_synthetic_shape.main(["--mesh", mesh["path"], "--object", CHAIN_EVAL_DB,
                                    "--log", os.path.join(root, "geometry.log")] + on)
    eval_s = time.perf_counter() - t0
    gt = get_database_eval_points(parse_database_name(CHAIN_DENSE_DB),
                                  voxel_size=CHAIN_DENSE_VOXEL)
    t0 = time.perf_counter()
    dense, _, _ = chamfer_distance(verts, gt, device=dev)
    dense_s = time.perf_counter() - t0
    sdf_mae = float(np.abs(scene_sdf("sphere")(verts)).mean())
    figures = [ev["chamfer"], float(dense), sdf_mae]
    check(all(math.isfinite(x) for x in figures), f"{tag}: Chamfer figures {figures}")
    after = read_launches()
    check(after == expect_launches(), f"{tag}: extraction and evaluation launched "
                                      f"{nonzero(after)}")
    print(f"{tag}: Chamfer on {CHAIN_EVAL_DB} (eval_synthetic_shape, {eval_s:.2f} s) "
          f"{ev['chamfer']:.6f} (pr-to-gt {ev['pr_to_gt']:.6f}, gt-to-pr {ev['gt_to_pr']:.6f}); "
          f"vertices to the {len(gt)}-point cloud of {CHAIN_DENSE_DB} at voxel "
          f"{CHAIN_DENSE_VOXEL}: {float(dense):.6f} ({len(verts)} x {len(gt)} on the card "
          f"{dense_s:.3f} s); mean |scene SDF| of the vertices {sdf_mae:.6f}")

    # Stage II on that mesh, through the neural tracer (B3)
    from nero_tpu_torch.core.config import load_cfg

    cfg2 = load_cfg(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "configs", "material", "proc", "bowl.yaml"))
    cfg2.update(name="chain_material", database_name=CHAIN_EVAL_DB, mesh=mesh["path"],
                model_root=root, vis_dir=root, total_step=CHAIN_STAGE2_STEPS,
                val_interval=CHAIN_STAGE2_STEPS, save_interval=10 * CHAIN_STAGE2_STEPS,
                train_log_step=1)
    cfg2_fn = write_cfg(cfg2, os.path.join(root, "material.yaml"))
    field_tracer({"vertices": verts, "triangles": tris}, "std", dev)   # distilled, cached
    t0 = time.perf_counter()
    trainer = Trainer(cfg2, device=dev)
    trainer.setup()
    setup_s = time.perf_counter() - t0
    reset_launches()
    trainer.run()
    torch.cuda.synchronize()
    stage2 = read_launches()
    hist = trainer.train_history
    check(len(hist) == CHAIN_STAGE2_STEPS, f"{tag}: {len(hist)} logged Stage-II steps")
    for h in hist:
        check(all(math.isfinite(v) for v in h.values()), f"{tag} Stage II step {h['step']}: {h}")
    want = expect_launches(sphere_march=CHAIN_STAGE2_STEPS + material_val_chunks(trainer.model))
    check(stage2 == want, f"{tag} Stage II launches {nonzero(stage2)}, expected {nonzero(want)}")
    step_ms = float(np.median([h["step_seconds"] for h in hist[2:]])) * 1e3
    print(f"{tag}: Stage II on the extracted mesh ({trainer.model.tbn} hit pixels; set-up with "
          f"the cached field {setup_s:.1f} s), {CHAIN_STAGE2_STEPS} steps (step {step_ms:.2f} ms, "
          f"median), loss_rgb " + ", ".join(f"{h['loss_rgb']:.5f}" for h in hist)
          + f", loss_total {hist[-1]['loss_total']:.5f}; launches {nonzero(stage2)}")

    # materials: per vertex, then the texture maps
    reset_launches()
    mats = extract_materials.main(["--cfg", cfg2_fn,
                                   "--output_dir", os.path.join(root, "materials")] + on)
    n_verts = len(verts)
    for k, v in mats["materials"].items():
        check(v.shape[0] == n_verts and np.isfinite(v).all() and v.min() >= 0 and v.max() <= 1,
              f"{tag} material {k}: shape {v.shape}, range {v.min()}..{v.max()}")
        check(os.path.exists(os.path.join(mats["dir"], f"{k}.npy")), f"{tag}: {k}.npy")
    tex = extract_materials_texture_map.main(
        ["--cfg", cfg2_fn, "--resolution", str(CHAIN_TEXTURE_RES),
         "--output_dir", os.path.join(root, "textures")] + on)
    for k in ("albedo", "metallic", "roughness"):
        v = tex[k]
        check(v.shape[:2] == (CHAIN_TEXTURE_RES, CHAIN_TEXTURE_RES) and np.isfinite(v).all()
              and v.min() >= 0 and v.max() <= 1, f"{tag} texture {k}: {v.shape}")
    for f in ("albedo.jpg", "metallic.jpg", "roughness.jpg", "material.mtl", "mesh.obj"):
        check(os.path.exists(os.path.join(tex["dir"], f)), f"{tag}: {f}")
    after = read_launches()
    check(after == expect_launches(), f"{tag}: material export launched {nonzero(after)}")
    print(f"{tag}: materials of {n_verts} vertices finite and in [0, 1], files written; "
          f"texture bake at {CHAIN_TEXTURE_RES}^2 {tex['bake_seconds']:.3f} s (atlas, host "
          f"rasteriser, material queries on the card, inpainting)")
    return [stage1, stage2]


# ---------------------------------------------------------------------------
# phase 8: the capture data path, COLMAP object on disk -> both stages
# ---------------------------------------------------------------------------

CAPTURE_NAME = "capture_sim"
CAPTURE_RES, CAPTURE_VIEWS = 300, 16    # run_real_pipeline's defaults
CAPTURE_RAW = f"custom/{CAPTURE_NAME}/raw_{CAPTURE_RES}"   # _resize_raw at ratio 1
CAPTURE_CROP = f"custom/{CAPTURE_NAME}/256"                # the crop cache
CAPTURE_STAGE2_STEPS = 5
REAL_STEPS1 = 300
REAL_ARGV = ["--steps1", str(REAL_STEPS1), "--steps2", str(CAPTURE_STAGE2_STEPS), "--max_len",
             "256", "--train_rays", "512", "--mesh_res", "128"]
DEMO_STEPS1, DEMO_STEPS2 = 100, 3
DEMO_TRACERS = ("neural", "grid", "bvh")
DEMO_ARGV = ["--scene", "capture", "--steps1", str(DEMO_STEPS1), "--steps2", str(DEMO_STEPS2),
             "--res", "100", "--mesh_res", "128", "--tracers2", ",".join(DEMO_TRACERS)]
# the reports' keys: those of tools/run_real_pipeline.py, and of
# tools/run_pipeline_demo.py for a scene other than 'sphere'
REAL_KEYS = {"export_seconds", "stage1_seconds", "stage1_psnr", "mesh_verts", "mesh_sdf_mae",
             "chamfer_vs_object_cloud", "stage2_seconds", "stage2_psnr"}
DEMO_KEYS = ({"stage1_seconds", "stage1_psnr", "mesh_verts", "chamfer", "mesh_sdf_mae",
              "stage2_psnr"} | {f"stage2_seconds_{t}" for t in DEMO_TRACERS}
             | {f"stage2_psnr_{t}" for t in DEMO_TRACERS})


def synced() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


class ToolProbe:
    """Around a pipeline tool's `main`: its trainers, each with its set-up
    seconds, synchronised step times, every step's log and the launches of
    its `run`, and the seconds of every field distillation. Patches the tool's `Trainer` and
    neural_tracer.distill_field; restores both on exit."""

    def __init__(self, tool):
        from nero_tpu_torch.geometry import neural_tracer

        self.tool, self.nt = tool, neural_tracer
        self.trainers, self.distill_s = [], []

    def __enter__(self):
        probe, base, distill = self, self.tool.Trainer, self.nt.distill_field

        class Recording(base):
            def setup(self):
                t0 = synced()
                super().setup()
                self.setup_s, self.step_s, self.logs = synced() - t0, [], []
                probe.trainers.append(self)

            def train_step(self, step):
                t0 = synced()
                log = super().train_step(step)
                self.step_s.append(synced() - t0)
                self.logs.append({k: float(v) for k, v in log.items()})
                return log

            def run(self):
                if self.model is None:
                    self.setup()
                before = read_launches()
                params = super().run()
                torch.cuda.synchronize()
                self.launches = {k: v - before[k] for k, v in read_launches().items()}
                return params

        def timed_distill(*args, **kw):
            t0 = synced()
            out = distill(*args, **kw)
            probe.distill_s.append(synced() - t0)
            return out

        self.saved = (base, distill)
        self.tool.Trainer, self.nt.distill_field = Recording, timed_distill
        return self

    def __exit__(self, *exc):
        self.tool.Trainer, self.nt.distill_field = self.saved


def add_launches(*counts: dict) -> dict:
    return {k: sum(c.get(k, 0) for c in counts) for c0 in counts for k in c0}


def stage2_expect(model, steps: int, val_passes: int = 1) -> dict:
    """Launches of `steps` Stage-II steps and `val_passes` renders of the
    validation view: one march per step and per chunk of hit pixels with the
    neural tracer (std field, sphere march), none with the grid or the BVH."""
    if type(model.ray_tracer).__name__ != "NeuralTracer":
        return expect_launches()
    return expect_launches(sphere_march=steps + val_passes * material_val_chunks(model))


def tool_report(tag: str, report: dict, keys: set):
    check(set(report) == keys, f"{tag}: report keys {sorted(report)}, expected {sorted(keys)}")
    check(all(math.isfinite(v) for v in report.values()), f"{tag}: report {report}")
    print(f"{tag}: report " + json.dumps(report))


def stage1_of_tool(tag: str, trainer, steps: int) -> dict:
    """The tool's Stage I: its run's launches as `stage1_expect` says, and
    the launches of one more validation render (the tool's PSNR)."""
    model = trainer.model
    chunks = stage1_val_chunks(model)
    occ = max(0, steps - model.scfg.occ_loss_step)
    want = stage1_expect(model.scfg, steps, val_chunks=chunks, occ_steps=occ)
    check(trainer.launches == want,
          f"{tag} Stage I launches {nonzero(trainer.launches)}, expected {nonzero(want)}")
    for i, log in enumerate(trainer.logs):
        check(all(math.isfinite(v) for v in log.values()), f"{tag} Stage I step {i}: {log}")
    print(f"{tag}: Stage I on {model.cfg['database_name']}: set-up {trainer.setup_s:.3f} s, "
          f"{steps} steps, step {np.median(trainer.step_s) * 1e3:.2f} ms (median, host clock "
          f"after synchronize), loss_rgb {trainer.logs[0]['loss_rgb']:.5f} -> "
          f"{trainer.logs[-1]['loss_rgb']:.5f}, val psnr "
          f"{trainer.val_results.get('val-psnr', float('nan')):.3f}; launches "
          f"{nonzero(trainer.launches)} = {steps} steps + {chunks} validation chunks")
    return stage1_expect(model.scfg, 0, val_chunks=chunks)


def stage2_of_tool(tag: str, trainer, steps: int) -> dict:
    """A Stage II of a tool: its run's launches for the tracer that the
    model chose, and those of one more validation render (the tool's PSNR)."""
    model = trainer.model
    tracer = type(model.ray_tracer).__name__
    want = stage2_expect(model, steps)
    check(trainer.launches == want,
          f"{tag} Stage II ({tracer}) launches {nonzero(trainer.launches)}, "
          f"expected {nonzero(want)}")
    for i, log in enumerate(trainer.logs):
        check(all(math.isfinite(v) for v in log.values()), f"{tag} Stage II step {i}: {log}")
    rms = getattr(model.ray_tracer, "distill_rms", float("nan"))
    print(f"{tag}: Stage II, tracer {model.cfg['tracer']} -> {tracer} (distill RMS {rms:.5f}), "
          f"{model.tbn} hit pixels, set-up {trainer.setup_s:.3f} s, {steps} steps, step "
          f"{np.median(trainer.step_s) * 1e3:.2f} ms (median, host clock after synchronize), "
          f"loss_rgb " + ", ".join(f"{log['loss_rgb']:.5f}" for log in trainer.logs)
          + f", val psnr {trainer.val_results.get('val-psnr', float('nan')):.3f}; launches "
          f"{nonzero(trainer.launches)}")
    return add_launches(want, stage2_expect(model, 0))


def check_png16(root: str):
    """PIL on this machine reads a 16-bit PNG back as the uint16 array it
    was given (the GlossySynthetic depth maps)."""
    import PIL

    from nero_tpu_torch.utils.image import imread, imsave

    depth = (np.random.RandomState(0).rand(33, 17) * 65535).astype(np.uint16)
    path = os.path.join(root, "depth16.png")
    imsave(path, depth)
    back = imread(path)
    check(back.dtype == np.uint16 and np.array_equal(back, depth),
          f"16-bit PNG read back as {back.dtype}")
    print(f"capture: PIL {PIL.__version__} reads a 16-bit PNG back as uint16, to the bit")


def capture(dev) -> list:
    """The capture data path: (a) the `capture` scene exported as a custom
    object (16 views at 300 px) and both image caches; (b) Stage I of
    configs/custom/kettle_shape.yaml on the raw images; (c)
    run_real_pipeline through the crop cache; (d) Stage II of
    configs/custom/kettle_material.yaml on (c)'s mesh; (e) run_pipeline_demo
    on the capture scene with every tracer. Returns the launches of each."""
    from nero_tpu_torch import run_pipeline_demo, run_real_pipeline
    from nero_tpu_torch.core.config import load_cfg
    from nero_tpu_torch.dataset import database
    from nero_tpu_torch.train.trainer import Trainer

    root = tempfile.mkdtemp(prefix="nero_smoke_capture_")
    saved_root, database.DATA_ROOT = database.DATA_ROOT, os.path.join(root, "data")
    tag = "capture"
    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "custom")
    on = ["--device", dev.type]
    try:
        check_png16(root)
        # (a) the export, then the parse + crop cache and the raw cache
        t0 = synced()
        obj = run_real_pipeline.export_scene(CAPTURE_NAME, CAPTURE_RES, CAPTURE_VIEWS)
        export_s = synced() - t0
        t0 = synced()
        crop = database.parse_database_name(CAPTURE_CROP)
        crop_s = synced() - t0
        t0 = synced()
        raw = database.parse_database_name(CAPTURE_RAW)
        raw_s = synced() - t0
        check(len(crop.get_img_ids()) == CAPTURE_VIEWS
              and crop.get_image(1).shape == (256, 256, 3)
              and raw.get_image(1).shape == (CAPTURE_RES, CAPTURE_RES, 3)
              and np.isclose(np.linalg.norm(raw.ref_points, axis=-1).max(), 1.0),
              f"{tag}: databases of the export")
        print(f"{tag}: export of {CAPTURE_VIEWS} views at {CAPTURE_RES} px {export_s:.3f} s; "
              f"COLMAP parse + normalisation + crop cache at 256 {crop_s:.3f} s; raw cache "
              f"{raw_s:.3f} s; {len(raw.ref_points)} object points")

        # (b) the shipped custom Stage I at its widths, on the raw images
        cfg = load_cfg(os.path.join(configs, "kettle_shape.yaml"))
        cfg.update(database_name=CAPTURE_RAW)
        raw_run = train("kettle_shape.yaml on " + CAPTURE_RAW, STAGE1_STEPS, dev, cfg=cfg)

        # (c) the real-capture tool through the crop cache
        reset_launches()
        with ToolProbe(run_real_pipeline) as probe:
            report = run_real_pipeline.main(REAL_ARGV + ["--out", os.path.join(root, "real")]
                                            + on)
        launches = read_launches()
        tool_report(f"{tag} run_real_pipeline", report, REAL_KEYS)
        check(report["mesh_verts"] > 100, f"{tag}: {report['mesh_verts']} mesh vertices")
        t1, t2 = probe.trainers
        want = add_launches(stage1_of_tool(f"{tag} run_real_pipeline", t1, REAL_STEPS1),
                            t1.launches, stage2_of_tool(f"{tag} run_real_pipeline", t2,
                                                        CAPTURE_STAGE2_STEPS))
        check(launches == want, f"{tag} run_real_pipeline launches {nonzero(launches)}, "
                                f"expected {nonzero(want)}")
        print(f"{tag} run_real_pipeline: distillation " + ", ".join(
            f"{s:.3f}" for s in probe.distill_s) + " s; Chamfer against the object cloud "
            f"{report['chamfer_vs_object_cloud']}, mean |scene SDF| {report['mesh_sdf_mae']}")
        real_launches = launches
        mesh = os.path.join(root, "real", f"real_shape-{REAL_STEPS1}.ply")

        # (d) the shipped custom Stage II on that mesh, over the raw images
        cfg = load_cfg(os.path.join(configs, "kettle_material.yaml"))
        cfg.update(database_name=CAPTURE_RAW, mesh=mesh, model_root=root, vis_dir=root,
                   total_step=CAPTURE_STAGE2_STEPS)
        trainer = Trainer(cfg, device=dev)
        t0 = synced()
        trainer.setup()
        setup_s = synced() - t0
        model = trainer.model
        mc = model.mcfg
        check(mc.human_lights and mc.outer_light_version == "sphere_direction"
              and (mc.diffuse_sample_num, mc.specular_sample_num) == (512, 256)
              and not mc.fused_lights, f"{tag} kettle_material.yaml: {mc}")
        reset_launches()
        logs, times = timed_steps(trainer, 0, CAPTURE_STAGE2_STEPS, f"{tag} Stage II")
        log = logs[-1]
        kettle = read_launches()
        want = stage2_expect(model, CAPTURE_STAGE2_STEPS, val_passes=0)
        check(kettle == want, f"{tag} kettle_material.yaml launches {nonzero(kettle)}, "
                              f"expected {nonzero(want)}")
        print(f"{tag}: kettle_material.yaml on {CAPTURE_RAW}, tracer "
              f"{type(model.ray_tracer).__name__}, {model.tbn} hit pixels, set-up {setup_s:.3f} "
              f"s, {CAPTURE_STAGE2_STEPS} steps, step {np.median(times[1:]) * 1e3:.2f} ms "
              f"(median after the first), last loss_rgb {log['loss_rgb']:.5f}; launches "
              f"{nonzero(kettle)}")

        # (e) the demo on the capture scene, every tracer
        reset_launches()
        with ToolProbe(run_pipeline_demo) as probe:
            report = run_pipeline_demo.main(DEMO_ARGV + ["--out", os.path.join(root, "demo")]
                                            + on)
        launches = read_launches()
        tool_report(f"{tag} run_pipeline_demo", report, DEMO_KEYS)
        t1, *stage2 = probe.trainers
        check(len(stage2) == len(DEMO_TRACERS), f"{tag}: {len(stage2)} Stage-II trainers")
        want = [stage1_of_tool(f"{tag} run_pipeline_demo", t1, DEMO_STEPS1), t1.launches]
        for t, name in zip(stage2, DEMO_TRACERS):
            want.append(stage2_of_tool(f"{tag} run_pipeline_demo ({name})", t, DEMO_STEPS2))
            print(f"{tag} run_pipeline_demo ({name}): Stage II {report[f'stage2_seconds_{name}']}"
                  f" s, psnr {report[f'stage2_psnr_{name}']}")
        want = add_launches(*want)
        check(launches == want, f"{tag} run_pipeline_demo launches {nonzero(launches)}, "
                                f"expected {nonzero(want)}")
        print(f"{tag} run_pipeline_demo: distillation " + ", ".join(
            f"{s:.3f}" for s in probe.distill_s) + " s")
        return [raw_run["launches"], real_launches, kettle, launches]
    finally:
        database.DATA_ROOT = saved_root


# ---------------------------------------------------------------------------
# phase 9: the precision switches in both stages, and the checkpoint
# ---------------------------------------------------------------------------

PRECISION_STEPS = 30
CKPT_STEP = 15             # the Stage-I run (a) checkpoints here; a fresh Trainer resumes
CKPT_TOL = 1e-5            # relative, each resumed step's loss against the unbroken run's
STEP0_F32_TOL = 1e-4       # Stage I step-0 loss, (e) against (d): both all-f32
# and (a)-(c) against (d), which they must differ from: measured 1.6e-5 to
# 6.3e-5 on the H100
STEP0_BF16_TOL = 5e-4
PSNR_TOL_DB = 0.5          # Stage II held-out PSNR against the all-f32 run
# Stage II against the all-f32 run, from the same parameters: the colours of
# one fixed batch before training (max |d|; each switch must move them), and
# the fall of the held-out loss over the 30 steps (relative). On the H100
# the sound runs gave colours within 2.9e-5 to 6.3e-5 and falls within
# 7.5e-5; the bf16 product with W for W^T in its square layers' cotangents
# gave 1.1e-3 (the tracer's normals are a backward inside the step) and a
# fall 39% short. Each bar sits between the two.
COLOR_TOL = 3e-4
FALL_TOL = 1e-3
PROFILED_STEPS = 3         # steps under torch.profiler for the busy time of each run
# (label, config keys, resolved sdf_grad_mode, resolved bf16_hidden); (d) and
# (e) also take matmul_precision "highest", so that they are f32 throughout
# (the card's default "default" gives the plain layers bf16 operands)
PRECISION_SHAPE_RUNS = (
    ("a: keys unset", {}, "fused", True),
    ("b: sdf_grad_mode rev", {"sdf_grad_mode": "rev"}, "rev", True),
    ("c: sdf_grad_mode fwd", {"sdf_grad_mode": "fwd"}, "fwd", True),
    ("d: bf16_hidden false", {"bf16_hidden": False, "matmul_precision": "highest"}, "rev",
     False),
    ("e: bf16_hidden false, fwd", {"bf16_hidden": False, "sdf_grad_mode": "fwd",
                                   "matmul_precision": "highest"}, "fwd", False),
)
# (label, matmul_precision, shader_cfg keys, resolved bf16_hidden); the last is
# the all-f32 run that the others are held against
PRECISION_MATERIAL_RUNS = (
    ("highest", "highest", {}, True),
    ("high", "high", {}, True),
    ("default (unset)", None, {}, True),
    ("highest, bf16_hidden false", "highest", {"bf16_hidden": False}, False),
)


def busy_line(trainer, step: int) -> dict:
    """Device busy ms per step over PROFILED_STEPS steps, by profile_step.py's
    counting, and the library matrix products' share of it."""
    from nero_tpu_torch.profile_step import device_breakdown

    b = device_breakdown(trainer, step, PROFILED_STEPS)
    return {"busy_ms": b["busy_ms"], "gemm_ms": b["library_gemm_ms"],
            "gemm_share": b["library_gemm_ms"] / max(b["busy_ms"], 1e-9)}


def precision_shape(label: str, over: dict, mode: str, bf16: bool, dev, card: str,
                    ckpt: bool = False) -> dict:
    """One Stage-I run of phase 9: PRECISION_STEPS steps of sphere.yaml from
    the seed, the resolved switches and every launch checked, the held-out
    loss_rgb falling; with `ckpt`, a checkpoint at CKPT_STEP that a fresh
    Trainer resumes, its steps held to the unbroken run's losses."""
    from nero_tpu_torch.render.rays import sample_ray_batch
    from nero_tpu_torch.train.trainer import Trainer

    root = tempfile.mkdtemp(prefix="nero_smoke_prec_")
    cfg = shape_cfg("sphere.yaml", root, total_step=PRECISION_STEPS, **over)
    tag = f"precision shape ({label})"
    trainer = Trainer(cfg, device=dev)
    trainer.setup()
    model = trainer.model
    check((model.scfg.sdf_grad_mode, model.scfg.bf16_hidden) == (mode, bf16),
          f"{tag}: resolved {model.scfg.sdf_grad_mode}, bf16_hidden {model.scfg.bf16_hidden}")
    d = model.train_data
    fixed = sample_ray_batch(torch.Generator(device=dev).manual_seed(7), d["imgs_u8"],
                             d["K_inv"], d["poses"], model.cfg["train_ray_num"],
                             d["human_poses"])

    def fixed_loss_rgb() -> float:
        with torch.no_grad(), trainer.precision():
            _, log = model.loss_fn(model.params, fixed, 0, gen=None)
        return float(log["loss_rgb"].mean())

    before = fixed_loss_rgb()
    reset_launches()
    first, t_first = timed_steps(trainer, 0, CKPT_STEP if ckpt else PRECISION_STEPS, tag)
    if ckpt:
        trainer.save(trainer.ckpt_fn, CKPT_STEP, 0.0)
        rest, t_rest = timed_steps(trainer, CKPT_STEP, PRECISION_STEPS, tag)
        first, t_first = first + rest, t_first + t_rest
    launches = read_launches()
    want = stage1_expect(model.scfg, PRECISION_STEPS)
    check(launches == want, f"{tag} launches {nonzero(launches)}, expected {nonzero(want)}")
    after = fixed_loss_rgb()
    check(after < before, f"{tag}: held-out loss_rgb did not fall: {before} -> {after}")
    step_s = float(np.median(t_first[2:]))
    busy = busy_line(trainer, PRECISION_STEPS)
    print(f"{tag}: {PRECISION_STEPS} steps, step-0 loss_total {first[0]['loss_total']:.8f}, "
          f"held-out loss_rgb {before:.5f} -> {after:.5f}, step {step_s * 1e3:.2f} ms (median), "
          f"{model.num_train_rays_per_step() / step_s:.1f} rays/s, busy {busy['busy_ms']:.2f} "
          f"ms/step ({busy['gemm_share']:.3f} library products), launches {nonzero(launches)}; "
          f"{card}")
    out = {"launches": launches, "loss0": first[0]["loss_total"], "step_ms": step_s * 1e3,
           **busy}
    if ckpt:
        out["resume"] = resume_check(cfg, dev, model, first[CKPT_STEP:], tag)
    return out


def resume_check(cfg: dict, dev, model, unbroken: list, tag: str) -> float:
    """A fresh Trainer resumes the checkpoint written at CKPT_STEP (nero_tpu's
    layout: O| keys for every parameter) and takes the remaining steps with
    the unbroken run's losses (CKPT_TOL relative). Returns the worst
    relative difference."""
    from nero_tpu_torch.core.convert import tree_items
    from nero_tpu_torch.train.trainer import Trainer

    resumed = Trainer(cfg, device=dev)
    resumed.setup()
    with np.load(resumed.ckpt_fn) as data:
        keys = set(data.files)
        counts = int(data["O|0|count"]), int(data["O|1|count"])
    leaves = [k for k, _ in tree_items(model.params)]
    want = {"__step__", "__best_para__", "O|0|count", "O|1|count", "R|gen"} | {
        p + k for k in leaves for p in ("P|", "O|0|mu|", "O|0|nu|")}
    check(keys == want and counts == (CKPT_STEP, CKPT_STEP),
          f"{tag} checkpoint: keys {sorted(keys ^ want)[:6]} differ, counts {counts}")
    _, step = resumed.resume()
    check(step == CKPT_STEP, f"{tag}: resumed at step {step}")
    logs, _ = timed_steps(resumed, CKPT_STEP, PRECISION_STEPS, f"{tag} resumed")
    worst = max(abs(a["loss_total"] - b["loss_total"]) / abs(b["loss_total"])
                for a, b in zip(logs, unbroken))
    print(f"{tag}: resumed at step {CKPT_STEP} from a checkpoint in nero_tpu's layout "
          f"({len(leaves)} parameters, O|0|count {counts[0]}); steps {CKPT_STEP}-"
          f"{PRECISION_STEPS - 1} differ from the unbroken run by at most {worst:.2e} "
          f"relative (< {CKPT_TOL})")
    check(worst < CKPT_TOL, f"{tag}: resumed losses differ by {worst}")
    return worst


def material_psnr(model, batches) -> tuple[float, float]:
    """(mean loss_rgb, PSNR) of the held-out batches shaded on the fixed
    direction lattice."""
    from nero_tpu_torch.render.shape import compute_rgb_loss

    loss, se, n = 0.0, 0.0, 0
    with torch.no_grad():
        for b in batches:
            colors, _ = model.shade(model.params, b, gen=None)
            loss += float(compute_rgb_loss(colors, b["rgb"], model.cfg["rgb_loss"]).mean())
            se += float(torch.sum((colors.clamp(0, 1) - b["rgb"]) ** 2))
            n += colors.numel()
    return loss / len(batches), -10.0 * math.log10(se / n)


def precision_material(label: str, mp, shader_over: dict, bf16: bool, bowl: dict, dev,
                       card: str) -> dict:
    """One Stage-II run of phase 9: PRECISION_STEPS steps of bowl.yaml at
    `matmul_precision` `mp` (None: unset), the resolved bf16_hidden and the
    launches checked, the held-out loss falling; its held-out PSNR."""
    from nero_tpu_torch.train.trainer import Trainer

    root = tempfile.mkdtemp(prefix="nero_smoke_prec2_")
    over = {} if mp is None else {"matmul_precision": mp}
    cfg = material_cfg(bowl, root, shader_over=shader_over, total_step=PRECISION_STEPS, **over)
    tag = f"precision material ({label})"
    trainer = Trainer(cfg, device=dev)
    trainer.setup()
    model = trainer.model
    check(model.mcfg.bf16_hidden == bf16, f"{tag}: bf16_hidden {model.mcfg.bf16_hidden}")
    held = [model.sample_batch(torch.Generator(device=dev).manual_seed(7 + i)) for i in range(4)]
    with torch.no_grad(), trainer.precision():
        colors0 = model.shade(model.params, held[0], gen=None)[0].double().cpu()
    before, _ = material_psnr(model, held)
    reset_launches()
    logs, times = timed_steps(trainer, 0, PRECISION_STEPS, tag)
    launches = read_launches()
    want = expect_launches(sphere_march=PRECISION_STEPS)
    check(launches == want, f"{tag} launches {nonzero(launches)}, expected {nonzero(want)}")
    after, psnr = material_psnr(model, held)
    check(after < before, f"{tag}: held-out loss_rgb did not fall: {before} -> {after}")
    step_s = float(np.median(times[2:]))
    busy = busy_line(trainer, PRECISION_STEPS)
    print(f"{tag}: {PRECISION_STEPS} steps, per-step loss_rgb {logs[0]['loss_rgb']:.6f} -> "
          f"{logs[-1]['loss_rgb']:.6f}, held-out loss_rgb {before:.7f} -> {after:.7f}, PSNR "
          f"{psnr:.5f} dB, step {step_s * 1e3:.2f} ms (median), "
          f"{model.num_train_rays_per_step() / step_s:.1f} points/s, busy "
          f"{busy['busy_ms']:.2f} ms/step, library products {busy['gemm_ms']:.2f} ms "
          f"({busy['gemm_share']:.3f} of busy); {card}")
    return {"launches": launches, "psnr": psnr, "step_ms": step_s * 1e3, "colors0": colors0,
            "fall": before - after, **busy}


def f32_matmul_kind(dev) -> str:
    """What an f32 matrix product computes in under the current settings:
    1 + 2^-9 survives TF32 (10 mantissa bits) but not bf16 (7), 1 + 2^-12
    survives f32 only."""
    ones = torch.ones(64, 16, device=dev)
    r9 = float((torch.full((16, 64), 1 + 2 ** -9, device=dev) @ ones)[0, 0])
    r12 = float((torch.full((16, 64), 1 + 2 ** -12, device=dev) @ ones)[0, 0])
    return "bf16" if r9 == 64.0 else ("tf32" if r12 == 64.0 else "f32")


def product_check(dev, card: str):
    """The three product modes of ops/mlp.py on the card: "bf16" gives an
    f32 result equal to the f64 product of the bf16-rounded operands to f32
    accumulation over up to 65,536 terms (1e-4 of the largest entry),
    forward and backward; "tf32"
    is TF32 and restores the flag; and what torch.set_float32_matmul_precision
    ("medium") gives, which the port does not use."""
    from nero_tpu_torch.ops.mlp import dense_product, product_mode, set_tf32

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(N_ROWS, 256, device=dev, generator=g).requires_grad_(True)
    w = torch.randn(256, 256, device=dev, generator=g).requires_grad_(True)
    with product_mode("bf16"):
        y = dense_product(x, w)
        gx, gw = torch.autograd.grad((y * y).sum(), (x, w))
    bf = lambda t: t.detach().bfloat16().double()
    ref = bf(x) @ bf(w)
    err = float((y.detach().double() - ref).abs().max() / ref.abs().max())
    gy = 2 * y.detach()
    err_gx = float((gx.double() - bf(gy) @ bf(w).T).abs().max() / gx.abs().max())
    err_gw = float((gw.double() - bf(x).T @ bf(gy)).abs().max() / gw.abs().max())
    check(y.dtype == gx.dtype == gw.dtype == torch.float32 and max(err, err_gx, err_gw) < 1e-4,
          f"bf16 product: {y.dtype}, errors {err}, {err_gx}, {err_gw}")
    with product_mode("tf32"):
        tf32 = f32_matmul_kind(dev)
    after = f32_matmul_kind(dev)
    torch.set_float32_matmul_precision("medium")
    medium = f32_matmul_kind(dev)
    torch.set_float32_matmul_precision("highest")
    set_tf32(False)
    check(tf32 == "tf32" and after == "f32" and f32_matmul_kind(dev) == "f32",
          f"product modes: tf32 context {tf32}, after it {after}")
    print(f"precision: torch {torch.__version__}: the bf16 product (torch.mm with out_dtype="
          f"float32) returns {y.dtype}, {err:.1e} / {err_gx:.1e} / {err_gw:.1e} of the f64 "
          f"product of bf16 operands (forward / dx / dW); the tf32 context computes in "
          f"{tf32}, f32 after it; set_float32_matmul_precision('medium') gives {medium}; "
          f"{card}")


def precision(bowl: dict, dev, card: str) -> list:
    """Phase 9: the product modes; Stage I under each resolution of
    sdf_grad_mode and bf16_hidden, with the checkpoint round trip on run (a);
    Stage II under each matmul_precision. Returns every run's launches."""
    product_check(dev, card)
    shape = {label: precision_shape(label, over, mode, bf16, dev, card, ckpt=i == 0)
             for i, (label, over, mode, bf16) in enumerate(PRECISION_SHAPE_RUNS)}
    ref = shape[PRECISION_SHAPE_RUNS[3][0]]["loss0"]
    for label, r in shape.items():
        rel = abs(r["loss0"] - ref) / abs(ref)
        if label.startswith("e"):
            ok, bar = rel < STEP0_F32_TOL, f"< {STEP0_F32_TOL}"
        else:
            # the bf16 paths moved the loss, by no more than their rounding
            ok, bar = 0 < rel < STEP0_BF16_TOL, f"in (0, {STEP0_BF16_TOL})"
        if not label.startswith("d"):
            print(f"precision shape: step-0 loss ({label}) differs from (d) by {rel:.3e} "
                  f"relative ({bar})")
            check(ok, f"precision shape ({label}) step-0 loss: {rel} from (d)")
    material = {label: precision_material(label, mp, over, bf16, bowl, dev, card)
                for label, mp, over, bf16 in PRECISION_MATERIAL_RUNS}
    f32 = material[PRECISION_MATERIAL_RUNS[-1][0]]
    for label, r in material.items():
        d = (r["colors0"] - f32["colors0"]).abs()
        fall = abs(r["fall"] - f32["fall"]) / abs(f32["fall"])
        print(f"precision material ({label}) against the all-f32 run: fixed-batch colours "
              f"before training max |d| {float(d.max()):.3e}, median {float(d.median()):.3e} "
              f"(max <= {COLOR_TOL}); held-out loss fall {r['fall']:.7e} vs {f32['fall']:.7e}, "
              f"{fall:.3e} relative (<= {FALL_TOL}); PSNR {r['psnr']:.5f} dB, "
              f"{r['psnr'] - f32['psnr']:+.5f} dB (within {PSNR_TOL_DB})")
        check(float(d.max()) <= COLOR_TOL and fall <= FALL_TOL
              and abs(r["psnr"] - f32["psnr"]) <= PSNR_TOL_DB,
              f"precision material ({label}) against the all-f32 run")
    # each switch moves the colours: the bf16 storage (highest against the
    # all-f32 run), TF32 (high against highest), the bf16 operands (default
    # against highest)
    labels = [r[0] for r in PRECISION_MATERIAL_RUNS]
    for a, b, what in ((labels[0], labels[3], "bf16 storage"), (labels[1], labels[0], "TF32"),
                       (labels[2], labels[0], "bf16 operands")):
        moved = float((material[a]["colors0"] - material[b]["colors0"]).abs().max())
        print(f"precision material: {what} moves the fixed-batch colours by {moved:.3e} "
              f"({a} against {b})")
        check(moved > 0, f"precision material: {what} left the colours as they were")
    return [r["launches"] for r in list(shape.values()) + list(material.values())]


# ---------------------------------------------------------------------------
# phase 10: scale-out (ray data parallelism, multi-scene) and FLOPs / MFU
# ---------------------------------------------------------------------------

SCALEOUT_STEPS1 = 30    # sphere.yaml, one NCCL rank against no group
SCALEOUT_STEPS2 = 10    # bowl.yaml, the same
MULTI_STEPS = 20        # two scenes of sphere.yaml through MultiSceneShapeModel
MULTI_SCENE_COUNTS = (1, 2, 4)  # the multi-scene step's host and busy ms at these S
MULTI_WARMUP, MULTI_TIMED = 3, 10
MULTI_REAL_STEPS = 4    # two scenes of sphere_real.yaml (B2's human_light variant)
MULTI_HEADS_STEPS = 8   # two scenes of sphere_heads.yaml (B8 and B6) ...
MULTI_HEADS_OCC = 5     # ... past occ_loss_step, set here: the occlusion march's B6 too
TOOL_STEPS = 4          # train_multi_scene, unbroken and resumed at half
GLOO_RANKS = 2          # on the one card, over gloo
# the two-rank step against one process: the ranks render the same rows with
# the same per-row kernels, and sum over rows in another order (f32)
GLOO_LOSS_BAR = 1e-5    # |loss_2 - loss_1| / |loss_1|
GLOO_GRAD_BAR = 1e-3    # grad_err_normalised of the all-reduced gradients
# runtime patches the bars must refuse (applied in the ranks, never in the tree)
GLOO_PATCHES = ("no_all_reduce", "local_draws", "local_kpr")
GLOO_TIMED = 5          # steps timed after the compared one, each synchronised
MFU_CONFIGS = ("sphere.yaml", "sphere_real.yaml", "sphere_heads.yaml", "bowl.yaml",
               "bowl_fused.yaml")
KERNEL_FAMILIES = ("sdf_grad", "shader", "predictor", "sdf_fwd", "sphere_march", "march",
                   "lights", "field_fwd")


def step_kernel_flops(model) -> dict:
    """{kernel counter: FLOPs} of one training step before occ_loss_step at
    the main path's shapes, by each module's flops(...): the tallies the
    wrappers must have added."""
    from nero_tpu_torch.ops import lights as KL, predictor as KP, sdf_fwd as KF, sdf_grad as KG
    from nero_tpu_torch.ops import shader as KS, sphere_march as KM

    out = {}
    add = lambda k, v: out.__setitem__(k, out.get(k, 0.0) + v)
    r = model.cfg["train_ray_num"]
    if hasattr(model, "scfg"):
        from nero_tpu_torch.fields.app_shading import fused_shader_active
        s = model.scfg
        rows = r * s.n_inner
        if s.sdf_grad_mode == "fused":
            n_pad = -(-rows // KG.TILE) * KG.TILE
            add("sdf_grad_fwd", KG.flops(n_pad))
            add("sdf_grad_bwd", KG.flops(n_pad, backward=True))
        sh = s.shader
        if fused_shader_active(sh, torch.bfloat16 if s.bf16_hidden else torch.float32):
            add("shader_fwd" + KS.variant(sh), KS.flops(rows, sh))
            add("shader_bwd" + KS.variant(sh), KS.flops(rows, sh, backward=True))
        elif sh.fused_heads:
            for name, (d_in, d_out) in KS.head_dims(sh).items():
                evals = 2 if name == "outer_light" else 1
                add(f"predictor_fwd_{d_in}x{d_out}", evals * KP.flops(rows, d_in, d_out))
                # the inner-weight head's input carries no gradient: no dx
                add(f"predictor_bwd_{d_in}x{d_out}",
                    evals * KP.flops(rows, d_in, d_out, True, want_dx=name != "inner_weight"))
        if s.use_fused_sdf:
            n_new = s.n_importance // s.up_sample_steps
            add("sdf_fwd", KF.flops(r * s.n_samples + (s.up_sample_steps - 1) * r * n_new))
    else:
        from nero_tpu_torch.fields.mc_shading import fused_lights_active
        mc, tr = model.mcfg, model.ray_tracer
        rows = r * (mc.diffuse_sample_num + mc.specular_sample_num)
        wide = "_wide" if tr.field_topology == "wide" else ""
        add("sphere_march" + wide, KM.flops(rows, tr.n_sphere, tr.n_refine, tr.field_topology))
        if fused_lights_active(mc):
            mode = "outer" if mc.inner_compact_frac > 0 else "both"
            suffix = "" if mode == "both" else "_outer"
            add("lights_fwd" + suffix, KL.flops(rows, mc, mode))
            add("lights_bwd" + suffix, KL.flops(rows, mc, mode, backward=True))
    return out


def mfu_record(tag: str, trainer) -> dict:
    """What phase 10 reads of a Trainer.run: the first step's FLOP count,
    the FLOPs its kernels should have tallied, the step median and the
    logged mfu (median, after the first two logged steps)."""
    hist = trainer.train_history[2:]
    return {"tag": tag, "flops": trainer.flops, "expect": step_kernel_flops(trainer.model),
            "step_ms": float(np.median([h["step_seconds"] for h in hist])) * 1e3,
            "mfu": float(np.median([h["mfu"] for h in hist]))}


def check_mfu(records: list, card: str):
    """Each configuration's FLOP tallies against launches x flops(...),
    expect_kernels on its kernels, and 0 < mfu < 1."""
    from nero_tpu_torch.core.mfu import expect_kernels, peak_flops_per_sec

    peak = peak_flops_per_sec(torch.device("cuda"))
    for rec in records:
        tag, f, want = rec["tag"], rec["flops"], rec["expect"]
        got = f["kernels_by_name"]
        print(f"mfu ({tag}): FLOPs a step {f['total']:.4e} = library {f['library']:.4e} + "
              f"kernels {f['kernels']:.4e} ({', '.join(f'{k} {v:.3e}' for k, v in got.items())});"
              f" step {rec['step_ms']:.3f} ms (median); mfu {rec['mfu']:.5f} of "
              f"{peak / 1e12:.1f} TFLOP/s dense bf16 [{card}]")
        check(set(got) == set(want) and f["unknown"] == 0,
              f"mfu ({tag}): tallied {sorted(got)}, expected {sorted(want)}, unknown "
              f"{f['unknown']}")
        for k, v in want.items():
            check(abs(got[k] - v) <= 1e-9 * v, f"mfu ({tag}): {k} tallied {got[k]}, "
                                                f"launches x flops(...) = {v}")
        expect_kernels({fam: any(k.startswith(fam) for k in want) for fam in KERNEL_FAMILIES},
                       f"mfu ({tag})", f["launches_by_name"])
        check(0 < rec["mfu"] < 1, f"mfu ({tag}): {rec['mfu']}")


def params_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def group_against_none(label: str, make_cfg, steps: int, dev, group, expect_fn,
                       card: str) -> dict:
    """`steps` steps through Trainer.train_step without a group and on the
    one-rank group: the same logs and parameters to the bit, the expected
    launches each. Returns the launches of both runs."""
    from nero_tpu_torch.train.trainer import Trainer

    runs = {}
    for tag, g in (("no group", None), ("one NCCL rank", group)):
        trainer = Trainer(make_cfg(tempfile.mkdtemp(prefix="nero_smoke_dp_")), device=dev, group=g)
        trainer.setup()
        reset_launches()
        logs, times = timed_steps(trainer, 0, steps, f"{label} ({tag})")
        launches = read_launches()
        want = expect_fn(trainer.model, steps)
        check(launches == want, f"{label} ({tag}) launches {nonzero(launches)}, expected "
                                f"{nonzero(want)}")
        runs[tag] = (logs, trainer.model.params, float(np.median(times[1:])) * 1e3, launches)
    (la, pa, ma, xa), (lb, pb, mb, xb) = runs.values()
    check(la == lb, f"{label}: the one-rank group's logs differ from no group's")
    check(params_equal(pa, pb), f"{label}: the one-rank group's parameters differ")
    print(f"{label}: {steps} steps, one NCCL rank equal to no group to the bit (every log value, "
          f"every parameter); step {ma:.2f} ms without a group, {mb:.2f} ms on the group "
          f"(median after the first) [{card}]; launches {nonzero(xb)} each")
    return add_launches(xa, xb)


class dp_patch:
    """One of GLOO_PATCHES in this process, undone on exit."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        from nero_tpu_torch.models import shape as MS
        from nero_tpu_torch.render import shape as RS

        occ = RS.compute_occ_loss

        def local_kpr(params, scfg, *args):
            # the kpr of the rank's own rows: max_pn // (R / W)
            shard = args[-1]
            return occ(params, scfg._replace(occ_loss_max_pn=scfg.occ_loss_max_pn
                                             * shard.group.size), *args)

        mod, attr, new = {"no_all_reduce": (MS, "all_reduce_grads", lambda params, group: None),
                          "local_draws": (RS, "draw_rows", lambda draw, shape, shard: draw(shape)),
                          "local_kpr": (RS, "compute_occ_loss", local_kpr)}[self.name]
        self.saved = (mod, attr, getattr(mod, attr))
        setattr(mod, attr, new)

    def __exit__(self, *exc):
        mod, attr, old = self.saved
        setattr(mod, attr, old)


def dp_step(cfg: dict, step: int, group, dev, timed: int = 0) -> tuple:
    """(loss, gradients as numpy, median ms of `timed` more steps) of one
    Stage-I step from the seed's parameters, on `group` (None: one
    process)."""
    from nero_tpu_torch.models.shape import NeROShapeModel

    model = NeROShapeModel(cfg, device=dev, group=group)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    log = model.train_step(opt, step)
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in model.parameters()]
    grads = [g.detach().cpu().numpy() for g in grads]
    times = []
    for i in range(timed):
        t0 = synced()
        model.train_step(opt, step + 1 + i)
        times.append(synced() - t0)
    return float(log["loss_total"]), grads, float(np.median(times)) * 1e3 if times else None


def gloo_rank(rank: int, init_file: str, cfg: dict, step: int, dev: str, out):
    """A rank of the two-rank group on the one card: the step unpatched and
    under each patch."""
    import traceback
    from datetime import timedelta

    import torch.distributed as dist

    try:
        dev = torch.device(dev)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=GLOO_RANKS, timeout=timedelta(seconds=300))
        from nero_tpu_torch.parallel.mesh import make_data_group

        group = make_data_group()
        res = {None: dp_step(cfg, step, group, dev, GLOO_TIMED)}
        for name in GLOO_PATCHES:
            with dp_patch(name):
                res[name] = dp_step(cfg, step, group, dev)
        dist.destroy_process_group()
        out.put((rank, "ok", res))
    except Exception:
        out.put((rank, "error", traceback.format_exc()))


def gloo_check(dev, card: str):
    """Two ranks on the one card over gloo, one step of sphere.yaml at
    occ_loss_step from the seed's parameters, against one process: the loss
    and the all-reduced gradients within their bars, each patch refused."""
    import multiprocessing as mp
    import queue

    from nero_tpu_torch.render.shape import shape_config_from_dict

    cfg = shape_cfg("sphere.yaml", tempfile.mkdtemp(prefix="nero_smoke_gloo_"))
    scfg = shape_config_from_dict(cfg)
    step = scfg.occ_loss_step
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    init_file = os.path.join(tempfile.mkdtemp(prefix="nero_smoke_gloo_init_"), "init")
    procs = [ctx.Process(target=gloo_rank, args=(r, init_file, cfg, step, str(dev), out))
             for r in range(GLOO_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        ref_loss, ref_grads, ref_ms = dp_step(cfg, step, None, dev, GLOO_TIMED)
        ranks, deadline = {}, time.time() + 600
        while len(ranks) < GLOO_RANKS:
            rank, status, value = out.get(timeout=max(deadline - time.time(), 1.0))
            check(status == "ok", f"gloo rank {rank} failed:\n{value}")
            ranks[rank] = value
    except queue.Empty:
        raise AssertionError(f"gloo ranks {sorted(set(range(GLOO_RANKS)) - set(ranks))} did "
                             "not finish in 600 s") from None
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    ref = [torch.from_numpy(g) for g in ref_grads]
    max_pn, rays = scfg.occ_loss_max_pn, scfg.train_ray_num
    print(f"scaleout gloo: {GLOO_RANKS} ranks on one card, {rays // GLOO_RANKS} rays each, "
          f"step {step} (kpr = {max_pn} // {rays} = {max_pn // rays}; from a rank's own rows "
          f"it would be {max_pn * GLOO_RANKS // rays}), one process's loss {ref_loss:.7f}; "
          f"{time.perf_counter() - t0:.1f} s with the spawns [{card}]")
    gloo_ms = [ranks[r][None][2] for r in range(GLOO_RANKS)]
    print(f"scaleout gloo: step {', '.join(f'{m:.2f}' for m in gloo_ms)} ms on the ranks, "
          f"{ref_ms:.2f} ms in one process beside them (median of {GLOO_TIMED} synchronised "
          f"steps each, the three processes sharing the card) [{card}]")
    for name in (None,) + GLOO_PATCHES:
        worst_loss = worst_grad = 0.0
        for r in range(GLOO_RANKS):
            loss, grads, _ = ranks[r][name]
            worst_loss = max(worst_loss, abs(loss - ref_loss) / abs(ref_loss))
            worst_grad = max(worst_grad, grad_err_normalised(
                ref, [torch.from_numpy(g) for g in grads]))
        inside = worst_loss < GLOO_LOSS_BAR and worst_grad < GLOO_GRAD_BAR
        print(f"scaleout gloo ({name or 'as built'}): loss off by {worst_loss:.3e} relative "
              f"(bar {GLOO_LOSS_BAR}), gradients by {worst_grad:.3e} normalised (bar "
              f"{GLOO_GRAD_BAR}): {'within' if inside else 'outside'} the bars")
        check(inside == (name is None), f"scaleout gloo ({name or 'as built'}): within the "
                                         f"bars = {inside}")


# the counters' stems of the kernels launched once for all scenes (B1, B2, B6, B8)
SCENE_KERNELS = ("sdf_grad_fwd", "sdf_grad_bwd", "shader_fwd", "shader_bwd", "sdf_fwd",
                 "predictor_fwd", "predictor_bwd")


def scenes_expect(scfg, steps: int, n_scenes: int, occ_steps: int = 0) -> dict:
    """Launches of `steps` steps of the multi-scene step over `n_scenes`
    scenes (`occ_steps` of them at or past occ_loss_step): B1, B2, B6 and B8
    once for all scenes under their `_scenes` counters (one scene's counts),
    any other kernel once a scene."""
    one = stage1_expect(scfg, steps, occ_steps=occ_steps)
    e = {}
    for k, v in one.items():
        if not v:
            continue
        base = next((b for b in SCENE_KERNELS if k.startswith(b)), None)
        if base is None:
            e[k] = n_scenes * v
        else:
            e[base + "_scenes" + k[len(base):]] = v
    return expect_launches(**e)


class SceneTrainer:
    """A multi-scene model and its optimizer as profile_step.py's
    `device_breakdown` drives a Trainer."""

    def __init__(self, model, schedule, dev):
        from nero_tpu_torch.train.trainer import make_optimizer
        self.model = model
        self.opt, self.sched = make_optimizer(model.parameters(), "adam", schedule, dev)

    def train_step(self, step: int) -> dict:
        log = self.model.train_step(self.opt, step)
        self.sched.step()
        return log


def scene_step_times(cfgs: list, schedule, dev, card: str) -> dict:
    """Host ms (median of MULTI_TIMED synchronised steps after MULTI_WARMUP)
    and device busy ms a step (profile_step.py's counting) of the
    multi-scene step of `cfgs` at each of MULTI_SCENE_COUNTS scenes."""
    from nero_tpu_torch.models.multi_scene import MultiSceneShapeModel
    from nero_tpu_torch.profile_step import device_breakdown

    out = {}
    for n in MULTI_SCENE_COUNTS:
        tr = SceneTrainer(MultiSceneShapeModel(cfgs[:n], device=dev), schedule, dev)
        times = []
        for step in range(MULTI_WARMUP + MULTI_TIMED):
            t0 = synced()
            tr.train_step(step)
            times.append(synced() - t0)
        host = float(np.median(times[MULTI_WARMUP:])) * 1e3
        busy = device_breakdown(tr, MULTI_WARMUP + MULTI_TIMED, PROFILED_STEPS)["busy_ms"]
        out[n] = {"host_ms": host, "busy_ms": busy}
        print(f"multi-scene step ({cfgs[0]['name'].rstrip('0123456789')}) at S = {n}: host "
              f"{host:.2f} ms (median of {MULTI_TIMED}), "
              f"device busy {busy:.2f} ms a step, idle share {max(0.0, 1 - busy / host):.3f}; "
              f"{host / n:.2f} ms a scene [{card}]")
        del tr
        torch.cuda.empty_cache()
    return out


def library_product_rounding(dev, card: str) -> dict:
    """The background NeRF's 256 x 256 product at one scene's 16,384 rows
    (512 rays x 32 outer samples), bf16 operands with an f32 result, forward
    and weight gradient, for two scenes: one batched product (torch.bmm)
    against each scene's torch.mm, which the multi-scene step runs. Reported:
    whether they are the same bits, and the largest difference."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((2, 16384, 256)), dtype=torch.bfloat16, device=dev)
    w = torch.as_tensor(rng.standard_normal((2, 256, 256)) / 16, dtype=torch.bfloat16,
                        device=dev)
    gy = torch.as_tensor(rng.standard_normal((2, 16384, 256)), dtype=torch.bfloat16, device=dev)
    f32 = torch.float32
    out = {}
    for what, a, b in (("forward", x, w), ("weight gradient", x.transpose(1, 2), gy)):
        batched = torch.bmm(a, b, out_dtype=f32)
        each = torch.stack([torch.mm(a[s], b[s], out_dtype=f32) for s in range(2)])
        out[what] = float((batched - each).abs().max())
        print(f"library products: the background NeRF's {what} product [2 x 16384, 256] by "
              f"torch.bmm against torch.mm scene by scene: "
              f"{'the same bits' if torch.equal(batched, each) else 'not the same bits'}, "
              f"max|d| {out[what]:.3e} [{card}]")
    return out


def multi_scene_check(dev, card: str) -> dict:
    """Two scenes of sphere.yaml through MultiSceneShapeModel's one step
    against each scene alone (seed random_seed + s), B1 and B2 once a step
    for both; the step's host and busy ms at 1, 2 and 4 scenes; two scenes
    of sphere_real.yaml; the library product that stays per scene; then
    train_multi_scene unbroken and resumed at half, its exports loaded into
    NeROShapeModel. Returns the multi-scene runs' launches."""
    from nero_tpu_torch import train_multi_scene
    from nero_tpu_torch.core.checkpoint import load_checkpoint
    from nero_tpu_torch.models.multi_scene import MultiSceneShapeModel
    from nero_tpu_torch.models.shape import NeROShapeModel
    from nero_tpu_torch.train.lr import warm_up_cos_schedule
    from nero_tpu_torch.train.trainer import make_optimizer

    root = tempfile.mkdtemp(prefix="nero_smoke_multi_")
    # the schedule's end fixed, so a run of fewer steps takes the same lr
    cfgs = [shape_cfg("sphere.yaml", root, name=f"scene{s}", lr_cfg={"end_iter": 300000})
            for s in range(max(MULTI_SCENE_COUNTS))]
    schedule = warm_up_cos_schedule(cfgs[0]["lr_cfg"])

    def train(model, params, steps):
        opt, sched = make_optimizer(params, "adam", schedule, dev)
        reset_launches()
        t0 = synced()
        for step in range(steps):
            model.train_step(opt, step)
            sched.step()
        return read_launches(), (synced() - t0) / steps * 1e3

    ms = MultiSceneShapeModel(cfgs[:2], device=dev)
    multi, multi_ms = train(ms, ms.parameters(), MULTI_STEPS)
    alone = []
    for s in range(2):
        m = NeROShapeModel({**cfgs[s], "random_seed": cfgs[s].get("random_seed", 6033) + s},
                           device=dev)
        launches, ms_alone = train(m, m.parameters(), MULTI_STEPS)
        check(params_equal(ms.scene_params(s), m.params),
              f"multi-scene: scene {s} differs from the scene alone")
        alone.append(launches)
    check(add_launches(*alone) == stage1_expect(ms.scfg, 2 * MULTI_STEPS),
          f"the scenes alone: launches {nonzero(add_launches(*alone))}")
    want = scenes_expect(ms.scfg, MULTI_STEPS, 2)
    check(multi == want, f"multi-scene launches {nonzero(multi)}, expected {nonzero(want)}")
    print(f"multi-scene: 2 scenes x {MULTI_STEPS} steps equal to the bit to each scene alone "
          f"(seeds 6033, 6034); launches {nonzero(multi)}: B1 and B2 once a step for both "
          f"scenes, no one-scene launch; {multi_ms:.1f} ms a step for both scenes, "
          f"{ms_alone:.1f} ms for one alone [{card}]")
    del ms
    torch.cuda.empty_cache()
    scene_step_times(cfgs, schedule, dev, card)

    real = [shape_cfg("sphere_real.yaml", root, name=f"real{s}", lr_cfg={"end_iter": 300000})
            for s in range(2)]
    ms_real = MultiSceneShapeModel(real, device=dev)
    real_launches, real_ms = train(ms_real, ms_real.parameters(), MULTI_REAL_STEPS)
    want = scenes_expect(ms_real.scfg, MULTI_REAL_STEPS, 2)
    check(real_launches == want,
          f"multi-scene sphere_real.yaml launches {nonzero(real_launches)}, expected {nonzero(want)}")
    print(f"multi-scene sphere_real.yaml: 2 scenes x {MULTI_REAL_STEPS} steps, launches "
          f"{nonzero(real_launches)}; {real_ms:.1f} ms a step [{card}]")
    del ms_real
    heads_launches = multi_scene_heads(root, schedule, dev, card)
    library_product_rounding(dev, card)

    paths = [write_cfg(c, os.path.join(root, f"{c['name']}.yaml")) for c in cfgs[:2]]
    argv = lambda r, n: ["--cfgs", *paths, "--total_step", str(n), "--model_root", r,
                         "--log_step", "1", "--save_interval", str(TOOL_STEPS // 2),
                         "--device", str(dev)]
    full = train_multi_scene.main(argv(os.path.join(root, "a"), TOOL_STEPS))
    train_multi_scene.main(argv(os.path.join(root, "b"), TOOL_STEPS // 2))
    resumed = train_multi_scene.main(argv(os.path.join(root, "b"), TOOL_STEPS))
    check([h["step"] for h in resumed["history"]] == list(range(TOOL_STEPS // 2, TOOL_STEPS)),
          f"train_multi_scene did not resume: {resumed['history']}")
    for s in range(2):
        check(params_equal(full["model"].scene_params(s), resumed["model"].scene_params(s)),
              f"train_multi_scene: scene {s} resumed differs from the unbroken run")
        model = NeROShapeModel(cfgs[s], training=False, device=dev)
        check(load_checkpoint(full["exports"][s], model.params)[0] == TOOL_STEPS,
              "train_multi_scene export step")
        check(params_equal(model.params, full["model"].scene_params(s)),
              f"train_multi_scene: the export of scene {s} does not load into NeROShapeModel")
    print(f"train_multi_scene: {TOOL_STEPS} steps unbroken and resumed at {TOOL_STEPS // 2} "
          f"equal to the bit; {full['checkpoint']} in the stacked layout; both exports load "
          f"into NeROShapeModel")
    return add_launches(multi, real_launches, heads_launches)


def multi_scene_heads(root: str, schedule, dev, card: str) -> dict:
    """Two scenes of sphere_heads.yaml (the per-head shader on B8, the
    sampler and the occlusion march on B6) through MultiSceneShapeModel's
    one step for MULTI_HEADS_STEPS steps, past occ_loss_step (set to
    MULTI_HEADS_OCC), each equal to the bit to the scene trained alone (seed
    6033 + s); every kernel once a step for both scenes under its `_scenes`
    counters, no one-scene launch; the step's host and busy ms at 1, 2 and 4
    scenes. Returns the two-scene run's launches."""
    from nero_tpu_torch.models.multi_scene import MultiSceneShapeModel
    from nero_tpu_torch.models.shape import NeROShapeModel
    from nero_tpu_torch.train.trainer import make_optimizer

    cfgs = [shape_cfg("sphere_heads.yaml", root, name=f"heads{s}", lr_cfg={"end_iter": 300000},
                      occ_loss_step=MULTI_HEADS_OCC) for s in range(max(MULTI_SCENE_COUNTS))]

    def train(model, steps):
        opt, sched = make_optimizer(model.parameters(), "adam", schedule, dev)
        reset_launches()
        t0 = synced()
        for step in range(steps):
            log = model.train_step(opt, step)
            sched.step()
        return read_launches(), (synced() - t0) / steps * 1e3, log

    ms = MultiSceneShapeModel(cfgs[:2], device=dev)
    multi, multi_ms, log = train(ms, MULTI_HEADS_STEPS)
    check(all(float(log[s]["loss_occ"]) > 0.0 for s in range(2)),
          f"multi-scene sphere_heads.yaml: no occlusion loss at step {MULTI_HEADS_STEPS - 1}")
    alone = []
    for s in range(2):
        m = NeROShapeModel({**cfgs[s], "random_seed": cfgs[s].get("random_seed", 6033) + s},
                           device=dev)
        launches, ms_alone, _ = train(m, MULTI_HEADS_STEPS)
        check(params_equal(ms.scene_params(s), m.params),
              f"multi-scene sphere_heads.yaml: scene {s} differs from the scene alone")
        alone.append(launches)
        del m
    occ = MULTI_HEADS_STEPS - MULTI_HEADS_OCC
    check(add_launches(*alone) == stage1_expect(ms.scfg, 2 * MULTI_HEADS_STEPS, occ_steps=2 * occ),
          f"sphere_heads.yaml scenes alone: launches {nonzero(add_launches(*alone))}")
    want = scenes_expect(ms.scfg, MULTI_HEADS_STEPS, 2, occ_steps=occ)
    check(multi == want and all("_scenes" in k for k in nonzero(multi)),
          f"multi-scene sphere_heads.yaml launches {nonzero(multi)}, expected {nonzero(want)}")
    print(f"multi-scene sphere_heads.yaml: 2 scenes x {MULTI_HEADS_STEPS} steps ({occ} past "
          f"occ_loss_step {MULTI_HEADS_OCC}) equal to the bit to each scene alone (seeds 6033, "
          f"6034); launches {nonzero(multi)}: B1, B6 and B8 once for both scenes, no one-scene "
          f"launch; {multi_ms:.1f} ms a step for both scenes, {ms_alone:.1f} ms for one alone "
          f"[{card}]")
    del ms
    torch.cuda.empty_cache()
    scene_step_times(cfgs, schedule, dev, card)
    return multi


def scaleout(dev, card: str, bowl: dict, mfu_records: list) -> list:
    """Phase 10. Returns the launches of every run."""
    import torch.distributed as dist
    from nero_tpu_torch.parallel.mesh import make_data_group

    t0 = time.perf_counter()
    init_file = os.path.join(tempfile.mkdtemp(prefix="nero_smoke_nccl_"), "init")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{init_file}", rank=0, world_size=1)
    try:
        group = make_data_group()
        runs = [group_against_none(
            "scaleout stage I (sphere.yaml)",
            lambda root: shape_cfg("sphere.yaml", root, total_step=SCALEOUT_STEPS1),
            SCALEOUT_STEPS1, dev, group, lambda model, n: stage1_expect(model.scfg, n), card)]
        runs.append(group_against_none(
            "scaleout stage II (bowl.yaml)",
            lambda root: material_cfg(bowl, root, total_step=SCALEOUT_STEPS2),
            SCALEOUT_STEPS2, dev, group,
            lambda model, n: expect_launches(sphere_march=n), card))
    finally:
        dist.destroy_process_group()
    gloo_check(dev, card)
    runs.append(multi_scene_check(dev, card))
    check_mfu(mfu_records, card)
    print(f"scaleout: {time.perf_counter() - t0:.1f} s")
    return runs


# ---------------------------------------------------------------------------
# the TPU kernels' other encodings: their kernel cases (phase 2) and phase 11
# ---------------------------------------------------------------------------

ENC_MULTIRES = (4, 8, 10, 20)    # B1 at N_ROWS and B6 at N_OCC_MARCH
ENC_IDE_DEGS = (1, 2, 3, 4)      # B2's default variant at light PE 8; B5 in both modes
ENC_SHADER_DEG = 4               # B2's other variants at this degree and at
ENC_LIGHT_PE = (4, 10, 16)       # these light PEs
ENC_STAGE1 = "sphere_enc.yaml"   # multires 8, ide_deg 4, light_pos_freq 10, use_fused_sdf
ENC_STAGE2 = "bowl_enc.yaml"     # bowl_fused.yaml at ide_deg 4
ENC_SHORT_SHADER = (3, 6)        # sphere_real.yaml's human light at these encodings
ENC_SHORT_LIGHTS = 3             # the convex scene's outer head, sphere_direction
ENC_SHORT_STEPS = 4
# the new head shapes of the per-head path at ide_deg 4, light_pos_freq 10:
# outer (38; 76 with sphere_direction), inner 63 + 38, inner weight 63 + 39
ENC_PREDICTOR_SHAPES = ((38, 3), (76, 3), (101, 3), (102, 1))
# B2 at degree 5 past light PE 16: 20 within one 256-wide tile of light input,
# 32 and 64 past it (the inner head's 267 and 459 columns, in windows)
ENC_WIDE_PE = (20, 32, 64)
ENC_WIDE = (5, 32)               # also `human_light`, both, and the scene axis at S = 2
ENC_LPF32 = "sphere_lpf32.yaml"  # sphere.yaml at light_pos_freq 32
FIELD_PES = (0, 3, 7)            # B3, B4, B7 on `std` fields of these PE octaves
FIELD_PE_DISTILL = (600, 300_000)  # steps, samples of the pe 0 and 3 fields (kernel checks)


def enc_shader_cases() -> list:
    """(sphere, human, (ide_deg, light_pos_freq)) of B2's cases."""
    cases = [(False, False, (d, 8)) for d in ENC_IDE_DEGS] + [(False, False, (ENC_SHADER_DEG, 10))]
    cases += [(sp, hu, (ENC_SHADER_DEG, p)) for p in ENC_LIGHT_PE
              for sp, hu in ((True, False), (False, True), (True, True))]
    # degree 5 with light PE 12-30: the inner head's input cotangent outgrows
    # the tiles and the ring takes 64-row slabs; from 31 on the light inputs
    # outgrow the activation tile: windows and dX pieces (csrc/shader.cu)
    cases += [(False, True, ENC_SHORT_SHADER), (True, True, (5, max(ENC_LIGHT_PE)))]
    cases += [(False, False, (5, p)) for p in ENC_WIDE_PE]
    return cases + [(False, True, ENC_WIDE), (True, True, ENC_WIDE)]


def enc_builds() -> list:
    """The libraries (source, defines) of the other encodings that this
    script runs: each multires of B1 and B6, each (ide_deg, light_pos_freq)
    of B2, each degree of B5."""
    from nero_tpu_torch.ops import lights as KL
    from nero_tpu_torch.ops import sdf_grad as KG
    from nero_tpu_torch.ops import shader as KS

    jobs = [(name, KG.defines(m)) for m in ENC_MULTIRES for name in ("sdf_grad", "sdf_fwd")]
    jobs += [("shader", KS.defines(e)) for e in dict.fromkeys(c[2] for c in enc_shader_cases())]
    return jobs + [("lights", KL.defines(d)) for d in ENC_IDE_DEGS]


def enc_path_rows() -> set:
    """The kernel rows of the other encodings that phase 11's trainings
    launch; the kernel phase's other rows are checked there alone."""
    from nero_tpu_torch.ops import lights as KL
    from nero_tpu_torch.ops import sdf_grad as KG
    from nero_tpu_torch.ops import shader as KS

    rows = {KG.counter(k, 8) for k in ("sdf_grad_fwd", "sdf_grad_bwd", "sdf_fwd")}
    rows |= {f"shader_{d}{KS._suffix(False, False, (4, 10))}" for d in ("fwd", "bwd")}
    rows |= {f"shader_{d}{KS._suffix(False, True, ENC_SHORT_SHADER)}" for d in ("fwd", "bwd")}
    rows |= {f"shader_{d}{KS._suffix(False, False, ENC_WIDE)}" for d in ("fwd", "bwd")}
    rows |= {KL.counter(k, 4) for k in ("lights_fwd", "lights_bwd")}
    return rows | {KL.counter(k, ENC_SHORT_LIGHTS) for k in ("lights_fwd_outer", "lights_bwd_outer")}


def check_shader_spills(enc):
    """The four kernels of B2's library at `enc` in its four variants: 0
    spill bytes in ptxas."""
    from nero_tpu_torch.ops import shader as K
    from nero_tpu_torch.ops.cuda_build import ptxas_info

    info = {f"{kern}<{sp},{hu}>": ptxas_info("shader", f"{kern}\\w*Lb{sp}ELb{hu}E", K.defines(enc))
            for kern in ("shader_fwd_kernel", "shader_bwd_sweep_kernel",
                         "shader_bwd_params_kernel", "shader_bwd_reduce_kernel")
            for sp in (0, 1) for hu in (0, 1)}
    check(all(v.get("spill_bytes") == 0 for v in info.values()), f"shader {enc} spills: {info}")
    print(f"shader {enc}: 0 spill bytes in its 16 kernels; registers "
          + ", ".join(f"{k} {v.get('regs')}" for k, v in info.items()))


def check_encoding_kernels(dev, bowl: dict) -> list:
    """Every kernel at the encodings nero_tpu's kernels take beside the
    shipped ones, against its plain version at the bars of its shipped row
    (PERF.md section 6), with live PE weights in the SDF: B1 at each of
    ENC_MULTIRES (multires 20: the bars from the plain version's own f32
    error) and B6 there, equal to B1's sdf to the bit; B2 at ENC_IDE_DEGS
    and at (4, 10) in the default variant, and in each of `sphere_direction`,
    `human_light` and both at degree 4 and each of ENC_LIGHT_PE, the human
    light at (3, 6) and both at (5, 16), the default variant at degree 5 and
    each of ENC_WIDE_PE (0 spill bytes), `human_light` and both at ENC_WIDE
    and the scene axis there (S = 2); B5 at ENC_IDE_DEGS in both modes; B8
    at the head shapes of ide_deg 4 and light_pos_freq 10; B3, B4 and B7 on
    the bowl's fields at FIELD_PES (`check_field_pe`)."""
    t0 = time.perf_counter()
    rows = []
    for m in ENC_MULTIRES:
        rows += check_sdf(N_ROWS, dev, multires=m, full=False)
        rows += check_sdf_fwd_at(N_OCC_MARCH, m, dev)
    t_wide = 0.0
    for sphere, human, enc in enc_shader_cases():
        t1 = time.perf_counter()
        if enc[1] in ENC_WIDE_PE and not (sphere or human):
            check_shader_spills(enc)
        rows += check_shader(N_ROWS, dev, sphere, human, enc=enc, full=False)
        if enc[1] > max(ENC_LIGHT_PE):
            t_wide += time.perf_counter() - t1
    t1 = time.perf_counter()
    rows += check_shader_scenes(N_ROWS, 2, dev, enc=ENC_WIDE)
    print(f"encodings: B2 past light PE 16 in {t_wide + time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    rows += check_field_pe(bowl, N_MARCH_RAYS, dev)
    print(f"encodings: B3, B4, B7 at pe {FIELD_PES} in {time.perf_counter() - t1:.1f} s")
    for d in ENC_IDE_DEGS:
        rows += check_lights(N_MARCH_RAYS, dev, ide_deg=d, full=False)
    rows += check_predictor(N_ROWS, dev, shapes=ENC_PREDICTOR_SHAPES, full=False)
    path = enc_path_rows()
    for row in rows:
        row["on_path"] = row["name"] in path
    print(f"encodings: {len(rows)} kernel rows checked in {time.perf_counter() - t0:.1f} s")
    return rows


def check_field_pe(mesh: dict, n: int, dev) -> list:
    """B3, B4 and B7 at the `std` field's pe of FIELD_PES: a field of the
    bowl mesh distilled at each (FIELD_PE_DISTILL's steps and samples at pe
    0 and 3, the tracer's 3000 steps on 1.5 M at 7), the sphere march in both refine modes and the
    uniform march on n surface rays and on 1,001, and the one evaluation on
    n points, against their plain versions at check_field_kernels' bars;
    then the NeuralTracer at pe 7 against the exact host BVH (clearing-ray
    hit agreement >= 0.98). Kernel rows with times, at each pe."""
    from nero_tpu_torch.geometry.neural_tracer import NeuralTracer, sphere_segment
    from nero_tpu_torch.geometry.proc_mesh import surface_rays
    from nero_tpu_torch.models.material import DEFAULT_MATERIAL_CFG
    from nero_tpu_torch.ops import field_fwd as KF
    from nero_tpu_torch.ops import march as KM
    from nero_tpu_torch.ops import sphere_march as K

    from nero_tpu_torch.ops.cuda_build import ptxas_info

    # the kernels' instances at any pe (the shipped pe 6 has its own, checked
    # in check_field_kernels)
    ptx = {k: ptxas_info(k, rf"{k}_kernel\w*{field_instance(False, any_pe=True)}")
           for k in ("sphere_march", "march", "field_fwd")}
    check(all(v.get("spill_bytes") == 0 for v in ptx.values()), f"field kernels at any pe: {ptx}")
    print(f"field kernels' instances at any pe: ptxas {ptx}")
    o_np, d_np = surface_rays(mesh, n)
    o, d = torch.as_tensor(o_np, device=dev), torch.as_tensor(d_np, device=dev)
    out = []
    for pe in FIELD_PES:
        t0 = time.perf_counter()
        steps, samples = (3000, 1_500_000) if pe == max(FIELD_PES) else FIELD_PE_DISTILL
        tracer = NeuralTracer(mesh["vertices"], mesh["triangles"], verbose=False, device=dev,
                              seed=DEFAULT_MATERIAL_CFG["random_seed"], pe=pe,
                              distill_steps=steps, distill_samples=samples)
        torch.cuda.synchronize()
        print(f"distill (std, pe {pe}): {steps} steps on {samples} samples in "
              f"{time.perf_counter() - t0:.1f} s, near-band RMS {tracer.distill_rms:.5f}")
        packed, sfx = tracer.packed, f"_pe{pe}"
        t_enter, t_exit, _ = sphere_segment(o, d, tracer.bound)
        rays = (o, d, t_enter, t_exit)
        W, Fv = K.kernel_buffers(packed)
        kw = dict(n_sphere=tracer.n_sphere, margin=tracer.margin,
                  dt_frac=1.0 / (tracer.n_coarse - 1), pe=pe)
        worst = {"agree": 1.0, "median": 0.0, "max": 0.0}
        for m in (n, 1001):
            for refine, n_refine in (("illinois", 2), ("bisect", 8)):
                part = tuple(x[:m] for x in rays)
                _, st = march_agreement(
                    f"sphere_march{sfx}  {refine}-{n_refine}, R = {m}",
                    lambda: K.sphere_march(packed, *part, n_refine=n_refine, refine=refine, **kw),
                    lambda: K.sphere_march_plain(packed, *part, n_refine=n_refine,
                                                 refine=refine, **kw))
                worst = {"agree": min(worst["agree"], st["agree"]),
                         "median": max(worst["median"], st["median"]),
                         "max": max(worst["max"], st["max"])}
        args = (*rays, tracer.n_sphere, 2, True, 0.012 + 1e-6, tracer.margin, 0.9,
                kw["dt_frac"], 0.25, pe)
        ms = cuda_ms(lambda: K._launch(W, Fv, False, *args), iters=10)
        plain_ms = cuda_ms(lambda: K.sphere_march_plain(packed, *rays, n_refine=2,
                                                        refine="illinois", **kw),
                           iters=3, warmup=1)
        b_ms, b_by = bound(K.flops(n, tracer.n_sphere, 2, "std", pe), K.min_bytes(n))
        out.append({"name": f"sphere_march{sfx}", "route": "cuda",
                    "source": "nero_tpu_torch/csrc/sphere_march.cu",
                    "replaces": "nero_tpu/ops/pallas/march_kernel.py:338",
                    "max_abs_err": worst["max"], "median_abs_err": worst["median"],
                    "found_agreement": worst["agree"], "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        nc, nr = tracer.n_coarse, 8
        worst = {"agree": 1.0, "median": 0.0, "max": 0.0}
        for m in (n, 1001):
            part = tuple(x[:m] for x in rays)
            _, st = march_agreement(
                f"march{sfx}  c{nc}-r{nr}, R = {m}",
                lambda: KM.march(packed, *part, n_coarse=nc, n_refine=nr, pe=pe),
                lambda: KM.march_plain(packed, *part, n_coarse=nc, n_refine=nr, pe=pe))
            worst = {"agree": min(worst["agree"], st["agree"]),
                     "median": max(worst["median"], st["median"]), "max": max(worst["max"], st["max"])}
        ms = cuda_ms(lambda: KM._launch(W, Fv, False, *rays, nc, nr, 0.012 + 1e-6, pe), iters=10)
        plain_ms = cuda_ms(lambda: KM.march_plain(packed, *rays, n_coarse=nc, n_refine=nr,
                                                  pe=pe), iters=2, warmup=1)
        b_ms, b_by = bound(KM.flops(n, nc, nr, "std", pe), K.min_bytes(n))
        out.append({"name": f"march{sfx}", "route": "cuda",
                    "source": "nero_tpu_torch/csrc/march.cu",
                    "replaces": "nero_tpu/ops/pallas/march_kernel.py:190",
                    "max_abs_err": worst["max"], "median_abs_err": worst["median"],
                    "found_agreement": worst["agree"], "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        pts = (o + d * 0.02).contiguous()
        v_k = KF.field_fwd(packed, pts, pe)
        v_p = KF.field_fwd_plain(packed, pts, pe)
        torch.cuda.synchronize()
        e_plain = (v_k - v_p).abs().max().item()
        check(e_plain <= 1e-3, f"field_fwd{sfx}: max |d| to the plain version {e_plain}")
        ms = cuda_ms(lambda: KF._launch(W, Fv, False, pts, pe), iters=10)
        plain_ms = cuda_ms(lambda: KF.field_fwd_plain(packed, pts, pe), iters=5)
        b_ms, b_by = bound(KF.flops(n, "std", pe), KF.min_bytes(n))
        print(f"field_fwd{sfx}: max|d| to plain {e_plain:.3e} (atol 1e-3); launch ms: "
              f"sphere_march {out[-2]['ms']:.3f}, march {out[-1]['ms']:.3f}, field_fwd {ms:.4f}")
        out.append({"name": f"field_fwd{sfx}", "route": "cuda",
                    "source": "nero_tpu_torch/csrc/field_fwd.cu",
                    "replaces": "nero_tpu/ops/pallas/field_kernel.py:90", "max_abs_err": e_plain,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": None})
        if pe == max(FIELD_PES):
            tracer_vs_bvh(f"neural tracer (std, pe {pe}, sphere march)", tracer, o_np, d_np, o, d,
                          0.98, 0.01, 0.95)
    return out


def encodings(bowl: dict, dev, card: str) -> list:
    """Phase 11: `sphere_enc.yaml` and `bowl_enc.yaml` trained for 30 steps
    each as phases 4 and 5 train theirs (launches exact, held-out loss_rgb
    falling, finite losses and PSNR), B1, B6, B2 and B5 launched at their
    widths; then 4 steps of `sphere_real.yaml` at ide_deg 3 and
    light_pos_freq 6 (B2 `human_light`) and 4 of the convex scene's fused
    outer head at ide_deg 3 with `sphere_direction` (B5 `outer`); step
    medians and busy ms a step beside the card line. Then `sphere_lpf32.yaml`
    for 30 steps as phase 4 trains its configs (B2 at (5, 32) under its
    `_d5p32` counters, launches exact, held-out loss_rgb falling) and its
    first step's FLOP tallies and MFU as phase 10 holds them."""
    from nero_tpu_torch.geometry.proc_mesh import proc_mesh
    from nero_tpu_torch.ops import lights as KL
    from nero_tpu_torch.ops import sdf_grad as KG
    from nero_tpu_torch.ops import shader as KS
    from nero_tpu_torch.profile_step import device_breakdown

    t0 = time.perf_counter()
    s1 = train(ENC_STAGE1, STAGE1_STEPS, dev, keep_trainer=True)
    s2 = train_material(bowl, FUSED_STEPS, dev, ENC_STAGE2, fused=True, keep_trainer=True)
    want = [KG.counter("sdf_grad_fwd", 8), KG.counter("sdf_grad_bwd", 8), KG.counter("sdf_fwd", 8),
            "shader_fwd" + KS._suffix(False, False, (4, 10)),
            "shader_bwd" + KS._suffix(False, False, (4, 10))]
    check(all(s1["launches"].get(k, 0) > 0 for k in want), f"{ENC_STAGE1}: {nonzero(s1['launches'])}")
    check(all(s2["launches"].get(KL.counter(k, 4), 0) > 0 for k in ("lights_fwd", "lights_bwd")),
          f"{ENC_STAGE2}: {nonzero(s2['launches'])}")
    busy = {}
    for tag, run in ((ENC_STAGE1, s1), (ENC_STAGE2, s2)):
        b = device_breakdown(run["trainer"], STAGE1_STEPS + 1, PROFILED_STEPS)
        busy[tag] = b["busy_ms"]
        del run["trainer"]
    h = short_shape_run(f"human light at ide_deg {ENC_SHORT_SHADER[0]}, light_pos_freq "
                        f"{ENC_SHORT_SHADER[1]}", ENC_SHORT_STEPS, dev, "sphere_real.yaml",
                        shader_over={"ide_deg": ENC_SHORT_SHADER[0],
                                     "light_pos_freq": ENC_SHORT_SHADER[1]})
    key = "shader_fwd" + KS._suffix(False, True, ENC_SHORT_SHADER)
    check(h["launches"].get(key, 0) == ENC_SHORT_STEPS, f"{key}: {nonzero(h['launches'])}")

    def convex_regime(model):
        check(model.mcfg.inner_compact_frac > 0.0 and model.mcfg.outer_compact_frac == 0.0
              and model.mcfg.ide_deg == ENC_SHORT_LIGHTS, f"convex regime: {model.mcfg}")

    n = ENC_SHORT_STEPS
    outer = short_material_run(
        f"convex, fused lights at ide_deg {ENC_SHORT_LIGHTS}: outer head only", proc_mesh("sphere"),
        n, dev, {"sphere_march": n, KL.counter("lights_fwd_outer", ENC_SHORT_LIGHTS): n,
                 KL.counter("lights_bwd_outer", ENC_SHORT_LIGHTS): n}, convex_regime,
        shader_over={"human_lights": True, "outer_light_version": "sphere_direction",
                     "fused_lights": True, "ide_deg": ENC_SHORT_LIGHTS},
        database_name="proc/sphere/100_12", name="proc_sphere_material")
    t1 = time.perf_counter()
    wide = train(ENC_LPF32, STAGE1_STEPS, dev)
    want = ["shader_fwd" + KS._suffix(False, False, ENC_WIDE),
            "shader_bwd" + KS._suffix(False, False, ENC_WIDE)]
    check(all(wide["launches"].get(k, 0) > 0 for k in want),
          f"{ENC_LPF32}: {nonzero(wide['launches'])}")
    check_mfu([wide["mfu"]], card)
    print(f"{card}: {ENC_STAGE1} step {s1['step_ms']:.2f} ms (median), busy "
          f"{busy[ENC_STAGE1]:.2f} ms a step; {ENC_STAGE2} step {s2['step_ms']:.2f} ms, busy "
          f"{busy[ENC_STAGE2]:.2f} ms; human light ({ENC_SHORT_SHADER}) {h['step_ms']:.2f} ms; "
          f"{ENC_LPF32} step {wide['step_ms']:.2f} ms ({time.perf_counter() - t1:.1f} s with its "
          f"checks)")
    print(f"encodings: phase 11 in {time.perf_counter() - t0:.1f} s")
    return [s1["launches"], s2["launches"], h["launches"], outer, wide["launches"]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=["kernels", "capture", "precision", "scaleout", "encodings"],
                    default=None,
                    help="kernels: stop after the kernel and tracer checks (no training, no "
                         "result line); capture: build, then phase 8 alone (no result line); "
                         "precision: build, then phase 9 alone (no result line); scaleout: "
                         "build, the five trainings of phases 4 and 5 whose FLOPs phase 10 "
                         "reads, then phase 10 (no result line); encodings: build, the kernel "
                         "cases of the other encodings, then phase 11 (no result line)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from nero_tpu_torch.geometry.proc_mesh import proc_mesh
    from nero_tpu_torch.ops import cuda_build

    from nero_tpu_torch.ops.mlp import set_tf32

    dev = torch.device("cuda")
    start = time.perf_counter()
    # f32 products outside the trainers' precision contexts
    set_tf32(False)
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    builds = cuda_build.build_all(list(cuda_build.SOURCES) + enc_builds())
    print(f"build: {time.perf_counter() - t0:.1f} s, {len(builds)} libraries at once; each from "
          f"the start to its end: " + ", ".join(f"{k} {v:.1f} s" for k, v in builds.items()))
    for name in cuda_build.SOURCES:
        log = cuda_build.load(name)._name + ".log"
        if os.path.exists(log):
            for line in open(log):
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

    if args.only == "capture":
        launches = add_launches(*capture(dev))
        print(f"capture: launches {nonzero(launches)}; {time.perf_counter() - start:.1f} s")
        return 0
    if args.only == "precision":
        launches = add_launches(*precision(proc_mesh("bowl"), dev, card))
        print(f"precision: launches {nonzero(launches)}; {time.perf_counter() - start:.1f} s")
        return 0
    if args.only == "encodings":
        bowl = proc_mesh("bowl")
        kernels = check_encoding_kernels(dev, bowl)
        launches = add_launches(*encodings(bowl, dev, card))
        print(f"encodings: launches {nonzero(launches)}; {time.perf_counter() - start:.1f} s")
        print("kernels: " + ", ".join(k["name"] for k in kernels))
        print(json.dumps({"kernels": kernels}))
        return 0
    if args.only == "scaleout":
        bowl = proc_mesh("bowl")
        runs = [train(f, STAGE1_STEPS, dev) for f in MFU_CONFIGS[:3]]
        runs += [train_material(bowl, UNFUSED_STEPS, dev, "bowl.yaml", fused=False),
                 train_material(bowl, FUSED_STEPS, dev, "bowl_fused.yaml", fused=True)]
        launches = add_launches(*scaleout(dev, card, bowl, [r["mfu"] for r in runs]))
        print(f"scaleout: launches {nonzero(launches)}; {time.perf_counter() - start:.1f} s")
        return 0
    kernels = check_stage1_kernels(dev)
    bowl = proc_mesh("bowl")
    kernels += check_lights(N_MARCH_RAYS, dev)
    kernels += check_field_kernels(bowl, N_MARCH_RAYS, dev)
    kernels += check_encoding_kernels(dev, bowl)
    if args.only == "kernels":
        print(json.dumps({"kernels": kernels}))
        return 0
    stage1 = {f: train(f, STAGE1_STEPS, dev)
              for f in ("sphere.yaml", "sphere_real.yaml", "sphere_heads.yaml")}
    # the per-head path with the value-only SDF kernel against the default
    # path, same seed and batches: bf16 SDF values move the sampler's z (up to
    # inv_s = 512 amplifies them), so the curves agree closely, not exactly
    ref, heads = stage1["sphere.yaml"], stage1["sphere_heads.yaml"]
    d_held = abs(ref["held_out"] - heads["held_out"])
    d_curve = max(abs(a - b) for a, b in zip(ref["loss_rgb"], heads["loss_rgb"]))
    print(f"sphere_heads.yaml against sphere.yaml: held-out loss_rgb differs by {d_held:.2e} "
          f"(< {HEADS_HELD_OUT_TOL}), per-step loss_rgb by at most {d_curve:.2e} "
          f"(< {HEADS_CURVE_TOL})")
    check(d_held < HEADS_HELD_OUT_TOL and d_curve < HEADS_CURVE_TOL,
          f"sphere_heads.yaml loss curve: held-out {d_held}, per step {d_curve}")
    runs = [r["launches"] for r in stage1.values()] + shape_variants(dev)
    stage2 = [train_material(bowl, UNFUSED_STEPS, dev, "bowl.yaml", fused=False),
              train_material(bowl, FUSED_STEPS, dev, "bowl_fused.yaml", fused=True)]
    runs += [r["launches"] for r in stage2]
    runs += material_variants(bowl, dev)
    runs += chain(dev)
    runs += capture(dev)
    runs += precision(bowl, dev, card)
    runs += scaleout(dev, card, bowl, [r["mfu"] for r in list(stage1.values()) + stage2])
    runs += encodings(bowl, dev, card)
    launches = {k: sum(r.get(k, 0) for r in runs) for r0 in runs for k in r0}
    for k in kernels:
        k["launches"] = launches.get(k.get("counter", k["name"]), 0)
        # the one-evaluation kernel has no caller on a training path, here as
        # in the JAX package: it is launched and checked above only
        if k["name"].startswith("field_fwd"):
            k["note"] = "no training path calls it, here as in the JAX package"
        elif not k.pop("on_path", True):
            k["note"] = k.get("note") or ("checked in the kernel phase at this encoding; no "
                                          "training run of this script takes it")
        else:
            check(k["launches"] > 0, f"{k['name']} was not launched by any training run")
    for k in kernels:
        both = (f" [launch {k['launch_ms']:.3f}, wrapper {k['wrapper_ms']:.3f}]"
                if "launch_ms" in k else "")
        print(f"kernel {k['name']}: {k['ms']:.3f} ms{both} (plain {k['plain_ms']:.3f} ms, bound "
              f"{k['bound_ms']:.3f} ms by {k['bound_by']}), max err {k['max_abs_err']:.3e}, "
              f"launches {k['launches']}")
    print("kernels: " + ", ".join(k["name"] for k in kernels))
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s from the card check to the result")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
