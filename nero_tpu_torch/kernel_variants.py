"""Times variants of the SDF-with-gradient forward kernel on the card.

    python -m nero_tpu_torch.kernel_variants [--parent OLD/sdf_grad.cu] [NAME ...]

Each variant is `csrc/sdf_grad.cu` with one design choice of its forward
kernel undone or one part of its work taken out (VARIANTS), built by nvcc
from a patched copy (one process each, in parallel) into
`build/nero_tpu_torch/variants/`. `--parent` adds another version of the
source, built as it is (an earlier commit's, with the same C entry). All are
launched on the same packed weights and points at N = 65,536, the training
lattice, in the given order and then in reverse, 20 timed launches each
after 3 untimed ones (CUDA events). Prints per variant the registers and
spill bytes that ptxas reported for the forward, the two times, and the
largest difference of sdf, grad and feats from the kernel as it is: the
variants that only reorganise the work must give 0 for sdf and feats.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import numpy as np
import torch

from nero_tpu_torch.fields.sdf import SDFConfig, init_sdf
from nero_tpu_torch.ops import cuda_build
from nero_tpu_torch.ops import sdf_grad as K
from nero_tpu_torch.ops.mlp import resolve_weight_norm

N = 65536
OUT_DIR = os.path.join(cuda_build.BUILD_DIR, "variants")

_EPILOGUE = """\
        const float zp = acc[0][j][e] + (e ? b2.y : b2.x);
        const float x = beta * zp;
        const float ex = expf(-fabsf(x));  // softplus_b's, shared with the sigmoid
        const float sg = __fdividef(x >= 0.0f ? 1.0f : ex, 1.0f + ex);
        const bool masked = l == 3 && col0 + j * 8 + 2 * t + e >= MASK_W;
        h[0][e] = masked ? 0.0f : div_beta(fmaxf(x, 0.0f) + log1pf(ex), beta, inv_beta);
        h[1][e] = masked ? 0.0f : sg * acc[0][j][2 + e];
        h[2][e] = masked ? 0.0f : sg * acc[1][j][e];
        h[3][e] = masked ? 0.0f : sg * acc[1][j][2 + e];"""
_NO_EPILOGUE = """\
        h[0][e] = acc[0][j][e] * 0.01f + b2.x;
        h[1][e] = acc[0][j][2 + e] * 0.01f;
        h[2][e] = acc[1][j][e] * 0.01f;
        h[3][e] = acc[1][j][2 + e] * 0.01f;"""
_MMA = """\
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));"""
# keeps the fragments live (ldmatrix stays), no tensor-core work
_NO_MMA = "  c[0] += __uint_as_float(a[0] & b0 & 0x3f800000u) - 1.0f;"


def _shape(wn: int, stages: int, slab_k: int):
    return [("constexpr int WN = 8;", f"constexpr int WN = {wn};"),
            ("constexpr int STAGES = 2;", f"constexpr int STAGES = {stages};"),
            ("constexpr int SLAB_K = 128;", f"constexpr int SLAB_K = {slab_k};")]


VARIANTS = {
    "kernel": [],
    # the first design: 8 warps of 32 rows x 128 columns (128 accumulators)
    "warps8_cols128": _shape(16, 2, 128),
    # weight slabs of 32 rows through a 4-stage ring
    "slab32_stages4": _shape(8, 4, 32),
    # softplus_b's IEEE division, and the IEEE sigmoid of the tangent rule
    "ieee_divisions": [
        ("div_beta(fmaxf(x, 0.0f) + log1pf(ex), beta, inv_beta)", "softplus_b(zp, beta)"),
        ("__fdividef(x >= 0.0f ? 1.0f : ex, 1.0f + ex)",
         "x >= 0.0f ? 1.0f / (1.0f + ex) : ex / (1.0f + ex)")],
    "no_epilogue": [(_EPILOGUE, _NO_EPILOGUE)],
    "no_mma": [(_MMA, _NO_MMA)],
    "weights_only": [(_EPILOGUE, _NO_EPILOGUE), (_MMA, _NO_MMA)],
}


def variant_source(name: str) -> str:
    with open(os.path.join(cuda_build.CSRC, "sdf_grad.cu")) as f:
        src = f.read()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise ValueError(f"variant {name}: csrc/sdf_grad.cu no longer holds {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(sources: dict) -> dict:
    """name -> source text; returns name -> (loaded library, ptxas summary)."""
    os.makedirs(OUT_DIR, exist_ok=True)
    jobs = {}
    for name, src in sources.items():
        cu, so = os.path.join(OUT_DIR, f"{name}.cu"), os.path.join(OUT_DIR, f"{name}.so")
        with open(cu, "w") as f:
            f.write(src)
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", cuda_build.CSRC, "-o", so, cu]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(so)
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sdf_grad_fwd.restype = i
        lib.sdf_grad_fwd.argtypes = [vp, i, vp, vp, f, f, vp, vp, vp, vp]
        # the parent's forward may be the template instance of the old kernel
        info = (cuda_build.parse_ptxas(log, "sdf_grad_fwd_kernel")
                or cuda_build.parse_ptxas(log, "sdf_rows_kernelILb0E"))
        libs[name] = (lib, f"{info.get('regs')} regs, {info.get('spill_bytes')} spill bytes")
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", default=list(VARIANTS), help="variants (all)")
    ap.add_argument("--parent", help="another sdf_grad.cu to build as it is")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA device")
    sources = {n: variant_source(n) for n in dict.fromkeys(["kernel", *args.names])}
    if args.parent:
        with open(args.parent) as f:
            sources["parent"] = f.read()
    libs = build(sources)

    dev = torch.device("cuda")
    cfg = SDFConfig()
    layers = resolve_weight_norm(init_sdf(torch.Generator().manual_seed(3), cfg, device=dev))
    with torch.no_grad():
        W, bias = K.pack_weights([l["w"] for l in layers], [l["b"] for l in layers])
    pts = torch.as_tensor(np.random.default_rng(1).uniform(-0.7, 0.7, (N, 3)).astype(np.float32),
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(lib):
        out = (torch.empty(N, device=dev), torch.empty(N, 3, device=dev),
               torch.empty(N, 256, device=dev))
        rc = lib.sdf_grad_fwd(pts.data_ptr(), N, W.data_ptr(), bias.data_ptr(), float(cfg.beta),
                              float(cfg.scale), *(o.data_ptr() for o in out), stream)
        cuda_build.check(rc, "sdf_grad_fwd")
        return out

    outs, times = {}, {n: [] for n in libs}
    for name in list(libs) + list(reversed(libs)):
        lib = libs[name][0]
        outs[name] = run(lib)
        for _ in range(3):
            run(lib)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            run(lib)
        end.record()
        torch.cuda.synchronize()
        times[name].append(start.elapsed_time(end) / 20)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    for name, (_, ptx) in libs.items():
        d = ", ".join(f"{(a - b).abs().max().item():.2e}" for a, b in zip(outs[name],
                                                                           outs["kernel"]))
        print(f"{name:16s} {ptx:26s} ms {times[name][0]:.4f} {times[name][1]:.4f}  "
              f"max|d| sdf, grad, feats {d}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
