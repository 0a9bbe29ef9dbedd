"""SDF with its spatial gradient: the CUDA kernel and its plain version.

Replaces nero_tpu/ops/pallas/sdf_grad_kernel.py::sdf_with_grad_fused (:469),
whose pallas_calls are nero_sdf_grad_fwd (:363) and nero_sdf_grad_bwd
(:387). The kernel source is csrc/sdf_grad.cu; its header comment gives the
design. `sdf_with_grad(..., mode)` computes the gradient by the mode that
the configuration resolved (render/shape.py::ShapeConfig.grad_mode), as
nero_tpu's three modes do:

* `fused`: the kernel for a CUDA tensor; its plain version
  (`sdf_with_grad_plain`) for a CPU tensor, and only then;
* `rev`: `sdf_with_grad_plain` on any device: reverse-mode double backprop
  through `torch.autograd.grad(create_graph=True)`;
* `fwd`: `sdf_with_grad_fwd` on any device: forward-mode tangents along the
  three axes (fields/sdf.py::sdf_apply_fwd).

`rev` and `fwd` store and multiply as ops/mlp.py's contexts say.

The kernel takes the SDF topology of nero_tpu's (8 layers of 256 with the
skip at 4, 257 outputs, weight norm) at any `multires` from 1 to 20, the
range of nero_tpu's kernel (3 + 6 multires <= its PE_PAD of 128): the
packed layout, the library (one build per multires, csrc/sdf_net.cuh's
NERO_SDF_MULTIRES), the launch counters and the FLOP counts follow
`layout(multires)`; the module's constants are the shipped multires 6's.

What bounds it on the card: tensor-core operations (`flops`), about
0.25 ms forward and 0.75 ms backward at N = 65,536 and 989 TFLOP/s; the
bytes it must move (points in, sdf/feats/grad out) are ~70 MB, 0.02 ms.

Gradients flow to the resolved weights (and through weight norm to v, g);
none flows to the points: z values are detached upstream, as on the TPU.

`sdf_with_grad_scenes` is the same function over S scenes' weights stacked on
a leading axis (parallel/scenes.py), as nero_tpu's `jax.vmap` of the multi-
scene step batches its pallas_calls: one launch each way for all scenes, on
a grid with a scene dimension, each scene's rows padded to the tile alone;
each scene's outputs and gradients are its one-scene launch's to the bit.
Off the kernel it runs the one-scene function scene by scene.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from nero_tpu_torch.fields.sdf import SDFConfig, sdf_apply, sdf_apply_fwd
from nero_tpu_torch.ops import cuda_build
from nero_tpu_torch.ops.mlp import resolve_weight_norm
from nero_tpu_torch.parallel.scenes import scene_slice

TILE = 32        # points per block (csrc/sdf_grad.cu P)
HID = 256
OUT_W = 272      # 257 outputs padded
MULTIRES = 6     # the shipped PE octaves: the library built without defines
MAX_MULTIRES = 20  # 3 + 6 multires <= 128, nero_tpu's PE_PAD


class Layout(NamedTuple):
    """csrc/sdf_net.cuh's widths at one multires."""
    multires: int
    n_pe: int         # PE channels, 3 + 6 multires
    pe_w: int         # padded to a multiple of 16 (PEW)
    skip_w: int       # layer 3's width, 256 - n_pe (MASK_W)
    widths: tuple     # out width per layer
    pack_shapes: tuple  # (rows, cols) of w0 w1 w2 w3 w4a w4b w5 w6 w7 w8


def layout(multires: int = MULTIRES) -> Layout:
    n_pe = 3 + 6 * multires
    pe_w = -(-n_pe // 16) * 16
    skip_w = HID - n_pe
    hh = (HID, HID)
    return Layout(multires, n_pe, pe_w, skip_w, (HID, HID, HID, skip_w, HID, HID, HID, HID, 257),
                  ((pe_w, HID), hh, hh, hh, hh, (pe_w, HID), hh, hh, hh, (HID, OUT_W)))


def defines(multires: int) -> tuple:
    """The build's -D macros: none at the shipped multires."""
    return () if multires == MULTIRES else (("NERO_SDF_MULTIRES", multires),)


def counter(name: str, multires: int) -> str:
    """A launch counter's name: the plain name at the shipped multires,
    `<name>_m<multires>` at another."""
    return name if multires == MULTIRES else f"{name}_m{multires}"


_DEFAULT = layout()
PE_W, SKIP_W, N_PE = _DEFAULT.pe_w, _DEFAULT.skip_w, _DEFAULT.n_pe
WIDTHS, PACK_SHAPES = _DEFAULT.widths, _DEFAULT.pack_shapes

# per multires: the plain names at 6, `_m<multires>` at another (added at its first launch)
# (`_scenes`: one launch for all scenes of the multi-scene step)
launches = {"sdf_grad_fwd": 0, "sdf_grad_bwd": 0, "sdf_grad_fwd_scenes": 0,
            "sdf_grad_bwd_scenes": 0}
# FLOPs of every counted launch, by `flops(...)` at the launch's shapes (core/mfu.py)
flop_tally = dict.fromkeys(launches, 0.0)
GRAD_MODES = ("rev", "fwd", "fused")


def _count(name: str, multires: int, flop: float) -> None:
    key = counter(name, multires)
    launches[key] = launches.get(key, 0) + 1
    flop_tally[key] = flop_tally.get(key, 0.0) + flop


def topology_supported(cfg: SDFConfig) -> bool:
    """nero_tpu's rule for its SDF kernels (render/shape.py::
    _fused_sdf_supported), with the PE within its PE_PAD: 8 layers of 256
    with the skip at 4, weight norm, multires 1-20. The value-only kernel
    takes these (ops/sdf_fwd.py)."""
    return (cfg.n_layers == 8 and cfg.skip == 4 and cfg.d_hidden == HID
            and 1 <= cfg.multires <= MAX_MULTIRES and cfg.weight_norm)


def supported(cfg: SDFConfig) -> bool:
    """The SDF-with-gradient kernel also needs the 257 outputs (nero_tpu's
    ShapeConfig.grad_mode)."""
    return topology_supported(cfg) and cfg.d_out == 257


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def sdf_with_grad_plain(params, x: torch.Tensor, cfg: SDFConfig = SDFConfig()):
    """(sdf [...,1], feats [...,d_out-1], grad [...,3]); grad = d sdf / dx,
    differentiable when grad mode is on (second order works through it)."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        out = sdf_apply(params, xg, cfg)
        (grad,) = torch.autograd.grad(out[..., 0].sum(), xg, create_graph=create)
    if not create:
        out = out.detach()
    return out[..., :1], out[..., 1:], grad


def sdf_with_grad_fwd(params, x: torch.Tensor, cfg: SDFConfig = SDFConfig()):
    """(sdf [...,1], feats [...,d_out-1], grad [...,3]) by forward-mode
    tangents (nero_tpu/fields/sdf.py:118-122); differentiable in the
    weights when grad mode is on."""
    out, grad = sdf_apply_fwd(params, x.detach(), cfg)
    return out[..., :1], out[..., 1:], grad


# ---------------------------------------------------------------------------
# kernel plumbing
# ---------------------------------------------------------------------------


def _lib(multires: int = MULTIRES):
    lib = cuda_build.load("sdf_grad", defines(multires))
    if not getattr(lib, "_nero_typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sdf_grad_weight_elems.restype = ctypes.c_size_t
        lib.sdf_grad_weight_elems.argtypes = []
        lib.sdf_grad_tile.restype = i
        lib.sdf_grad_tile.argtypes = []
        lib.sdf_grad_scratch_elems.restype = ctypes.c_size_t
        lib.sdf_grad_scratch_elems.argtypes = [i]
        lib.sdf_grad_part_elems.restype = ctypes.c_size_t
        lib.sdf_grad_part_elems.argtypes = [i]
        lib.sdf_grad_fwd.restype = i
        lib.sdf_grad_fwd.argtypes = [vp, i, vp, vp, f, f, vp, vp, vp, vp]
        lib.sdf_grad_bwd.restype = i
        lib.sdf_grad_bwd.argtypes = [vp, i, vp, vp, f, f, vp, vp, vp, vp, vp, vp, vp, vp]
        lib.sdf_grad_bwd_sweep.restype = i
        lib.sdf_grad_bwd_sweep.argtypes = [vp, i, vp, vp, f, f, vp, vp, vp, vp, vp]
        lib.sdf_grad_bwd_params.restype = i
        lib.sdf_grad_bwd_params.argtypes = [i, vp, vp, vp, vp, vp]
        # S scenes in one launch (S = 1: one scene): n_pad, then S
        lib.sdf_grad_fwd_scenes.restype = i
        lib.sdf_grad_fwd_scenes.argtypes = [vp, i, i, vp, vp, f, f, vp, vp, vp, vp]
        lib.sdf_grad_bwd_scenes.restype = i
        lib.sdf_grad_bwd_scenes.argtypes = [vp, i, i, vp, vp, f, f, vp, vp, vp, vp, vp, vp,
                                            vp, vp]
        if (lib.sdf_grad_tile() != TILE or lib.sdf_grad_weight_elems()
                != sum(r * c for r, c in layout(multires).pack_shapes)):
            raise RuntimeError("csrc/sdf_grad.cu layout differs from ops/sdf_grad.py")
        lib._nero_typed = True
    return lib


def multires_of(ws) -> int:
    """The multires of resolved weights: w0 is [3 + 6 multires, 256]."""
    return (ws[0].shape[0] - 3) // 6


def pack_weights(ws, bs):
    """Resolved weights [in,out] / biases -> (packed bf16 [W_TOTAL], bias f32
    [9, OUT_W]) in the kernel layout of the weights' multires; the skip layer
    is split into its h3 part (w4a) and its PE part (w4b), both scaled by
    1/sqrt(2)."""
    inv_s2 = 1.0 / math.sqrt(2.0)
    lay = layout(multires_of(ws))

    def pad(a, rows, cols):
        return F.pad(a, (0, cols - a.shape[1], 0, rows - a.shape[0]))

    parts = [ws[0], ws[1], ws[2], ws[3], ws[4][:lay.skip_w] * inv_s2,
             ws[4][lay.skip_w:] * inv_s2, ws[5], ws[6], ws[7], ws[8]]
    packed = torch.cat([pad(p, r, c).reshape(-1)
                        for p, (r, c) in zip(parts, lay.pack_shapes)])
    bias = torch.zeros(9, OUT_W, dtype=torch.float32, device=ws[0].device)
    for l, b in enumerate(bs):
        bias[l, :b.shape[0]] = b
    return packed.to(torch.bfloat16).contiguous(), bias


def unpack_grads(dW: torch.Tensor, db: torch.Tensor, multires: int = MULTIRES):
    """Kernel-layout gradients -> per-layer (dw [in,out], db [out])."""
    inv_s2 = 1.0 / math.sqrt(2.0)
    lay = layout(multires)
    sizes = [r * c for r, c in lay.pack_shapes]
    g = [t.view(r, c) for t, (r, c) in zip(torch.split(dW, sizes), lay.pack_shapes)]
    dws = [g[0][:lay.n_pe], g[1], g[2], g[3][:, :lay.skip_w],
           torch.cat([g[4][:lay.skip_w] * inv_s2, g[5][:lay.n_pe] * inv_s2]),
           g[6], g[7], g[8], g[9][:, :257]]
    dbs = [db[l, :w] for l, w in enumerate(lay.widths)]
    return dws, dbs


def _fwd(pts, W, bias, beta, scale, multires: int = MULTIRES):
    """One forward launch on packed weights, for one scene (pts [n_pad, 3],
    W [W_TOTAL], bias [9, OUT_W]) or for S (a leading scene axis on each):
    -> sdf [..., n_pad], grad [..., n_pad, 3], feats [..., n_pad, 256]. A
    launch for scenes counts under `sdf_grad_fwd_scenes`."""
    lead, n_pad = pts.shape[:-2], pts.shape[-2]
    dev = pts.device
    sdf = torch.empty(lead + (n_pad,), device=dev)
    grad = torch.empty(lead + (n_pad, 3), device=dev)
    feats = torch.empty(lead + (n_pad, HID), device=dev)
    name = "sdf_grad_fwd" + ("_scenes" if lead else "")
    rc = _lib(multires).sdf_grad_fwd_scenes(
        pts.data_ptr(), n_pad, math.prod(lead), W.data_ptr(), bias.data_ptr(), beta, scale,
        sdf.data_ptr(), grad.data_ptr(), feats.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, name)
    _count(name, multires, flops(math.prod(lead) * n_pad, multires=multires))
    return sdf, grad, feats


def bwd_buffers(n_pad: int, dev, multires: int = MULTIRES, n_scenes: int = 1):
    """The backward's scratch (bf16: H, GZ, layer 8's cotangent rows, the PE)
    and its per-chunk partials (f32), one torch.empty each; S scenes of
    n_pad rows take S times one scene's."""
    lib = _lib(multires)
    return (torch.empty(n_scenes * lib.sdf_grad_scratch_elems(n_pad), dtype=torch.bfloat16,
                        device=dev),
            torch.empty(n_scenes * lib.sdf_grad_part_elems(n_pad), device=dev))


def _bwd(pts, W, bias, beta, scale, g_sdf, g_grad, g_feats, multires: int = MULTIRES):
    """One backward call (three launches), for one scene or S as `_fwd`:
    -> dW [..., W_TOTAL], db [..., 9, OUT_W]."""
    lead, n_pad = pts.shape[:-2], pts.shape[-2]
    dev = pts.device
    scratch, part = bwd_buffers(n_pad, dev, multires, math.prod(lead))
    dW = torch.zeros(W.shape, device=dev)  # zero rows: the kernel writes nothing
    db = torch.zeros(lead + (9, OUT_W), device=dev)
    name = "sdf_grad_bwd" + ("_scenes" if lead else "")
    rc = _lib(multires).sdf_grad_bwd_scenes(
        pts.data_ptr(), n_pad, math.prod(lead), W.data_ptr(), bias.data_ptr(), beta, scale,
        g_sdf.data_ptr(), g_grad.data_ptr(), g_feats.data_ptr(), scratch.data_ptr(),
        part.data_ptr(), dW.data_ptr(), db.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, name)
    _count(name, multires, flops(math.prod(lead) * n_pad, backward=True, multires=multires))
    return dW, db


def _pad_rows(t: torch.Tensor, n_pad: int, dim: int = 0) -> torch.Tensor:
    """t as f32 with its rows (axis `dim`) padded with zeros to n_pad."""
    t = t.float()
    if t.shape[dim] != n_pad:
        shape = list(t.shape)
        shape[dim] = n_pad - t.shape[dim]
        t = torch.cat([t, t.new_zeros(shape)], dim)
    return t.contiguous()


class _SdfGradFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pts, beta, scale, *wb):
        n = pts.shape[0]
        n_pad = -(-n // TILE) * TILE
        W, bias = pack_weights(wb[:9], wb[9:])
        pts_p = _pad_rows(pts, n_pad)
        multires = multires_of(wb[:9])
        sdf, grad, feats = _fwd(pts_p, W, bias, beta, scale, multires)
        ctx.save_for_backward(pts_p, W, bias)
        ctx.n, ctx.beta, ctx.scale, ctx.multires = n, beta, scale, multires
        return sdf[:n, None], feats[:n], grad[:n]

    @staticmethod
    def backward(ctx, g_sdf, g_feats, g_grad):
        pts_p, W, bias = ctx.saved_tensors
        n, n_pad = ctx.n, pts_p.shape[0]

        def cot(g, shape):
            if g is None:
                return torch.zeros((n_pad,) + shape, device=pts_p.device)
            return _pad_rows(g.reshape((n,) + shape), n_pad)

        dW, db = _bwd(pts_p, W, bias, ctx.beta, ctx.scale, cot(g_sdf, ()),
                      cot(g_grad, (3,)), cot(g_feats, (HID,)), ctx.multires)
        dws, dbs = unpack_grads(dW, db, ctx.multires)
        return (None, None, None, *dws, *dbs)


def pack_scenes(ws, bs):
    """Stacked resolved weights [S, in, out] / biases [S, out] -> (packed
    bf16 [S, W_TOTAL], bias f32 [S, 9, OUT_W]), each scene packed as one
    scene's is."""
    packs = [pack_weights([w[s] for w in ws], [b[s] for b in bs]) for s in range(ws[0].shape[0])]
    return (torch.stack([p[0] for p in packs]).contiguous(),
            torch.stack([p[1] for p in packs]).contiguous())


class _SdfGradScenesFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pts, beta, scale, *wb):
        n = pts.shape[1]
        n_pad = -(-n // TILE) * TILE
        W, bias = pack_scenes(wb[:9], wb[9:])
        pts_p = _pad_rows(pts, n_pad, 1)
        multires = multires_of([w[0] for w in wb[:9]])
        sdf, grad, feats = _fwd(pts_p, W, bias, beta, scale, multires)
        ctx.save_for_backward(pts_p, W, bias)
        ctx.n, ctx.beta, ctx.scale, ctx.multires = n, beta, scale, multires
        return sdf[:, :n, None], feats[:, :n], grad[:, :n]

    @staticmethod
    def backward(ctx, g_sdf, g_feats, g_grad):
        pts_p, W, bias = ctx.saved_tensors
        n_scenes, n_pad = pts_p.shape[:2]
        n = ctx.n

        def cot(g, shape):
            if g is None:
                return torch.zeros((n_scenes, n_pad) + shape, device=pts_p.device)
            return _pad_rows(g.reshape((n_scenes, n) + shape), n_pad, 1)

        dW, db = _bwd(pts_p, W, bias, ctx.beta, ctx.scale, cot(g_sdf, ()),
                             cot(g_grad, (3,)), cot(g_feats, (HID,)), ctx.multires)
        per_scene = [unpack_grads(dW[s], db[s], ctx.multires) for s in range(n_scenes)]
        dws = [torch.stack(g) for g in zip(*[p[0] for p in per_scene])]
        dbs = [torch.stack(g) for g in zip(*[p[1] for p in per_scene])]
        return (None, None, None, *dws, *dbs)


def sdf_with_grad_scenes(params, x: torch.Tensor, cfg: SDFConfig = SDFConfig(),
                         mode: str = "fused"):
    """`sdf_with_grad` of S scenes: params stacked on a leading scene axis
    ({v,g,b} or resolved {w,b} layers, [S, ...] each), x [S, ..., 3] ->
    (sdf [S, ..., 1], feats [S, ..., d_out-1], grad [S, ..., 3]). `fused` on
    a CUDA tensor: one kernel launch each way for all scenes, no fallback;
    otherwise the one-scene function scene by scene."""
    if mode not in GRAD_MODES:
        raise ValueError(f"sdf_grad_mode must be one of {GRAD_MODES}, got {mode!r}")
    n_scenes = x.shape[0]
    if mode != "fused" or x.device.type == "cpu":
        outs = [sdf_with_grad(scene_slice(params, s), x[s], cfg, mode) for s in range(n_scenes)]
        return tuple(torch.stack(o) for o in zip(*outs))
    if not supported(cfg):
        raise NotImplementedError(f"the sdf_grad kernel needs 8 x 256 layers with the skip at "
                                  f"4, 257 outputs, weight norm and multires 1-20; got {cfg}")
    layers = resolve_weight_norm(params)
    ws = [l["w"] for l in layers]
    bs = [l["b"] for l in layers]
    shape = x.shape[:-1]
    sdf, feats, grad = _SdfGradScenesFn.apply(x.reshape(n_scenes, -1, 3).detach(),
                                              float(cfg.beta), float(cfg.scale), *ws, *bs)
    return (sdf.reshape(*shape, 1), feats.reshape(*shape, HID), grad.reshape(*shape, 3))


def sdf_with_grad(params, x: torch.Tensor, cfg: SDFConfig = SDFConfig(), mode: str = "fused"):
    """(sdf [...,1], feats [...,d_out-1], grad [...,3]) by `mode`: `fused`
    is the CUDA kernel for a CUDA tensor and the plain version for a CPU
    tensor; `rev` and `fwd` are plain on any device."""
    if mode not in GRAD_MODES:
        raise ValueError(f"sdf_grad_mode must be one of {GRAD_MODES}, got {mode!r}")
    if mode == "fwd":
        return sdf_with_grad_fwd(params, x, cfg)
    if mode == "rev" or x.device.type == "cpu":
        return sdf_with_grad_plain(params, x, cfg)
    if not supported(cfg):
        raise NotImplementedError(f"the sdf_grad kernel needs 8 x 256 layers with the skip at "
                                  f"4, 257 outputs, weight norm and multires 1-20; got {cfg}")
    layers = resolve_weight_norm(params)
    ws = [l["w"] for l in layers]
    bs = [l["b"] for l in layers]
    shape = x.shape[:-1]
    sdf, feats, grad = _SdfGradFn.apply(x.reshape(-1, 3).detach(), float(cfg.beta),
                                        float(cfg.scale), *ws, *bs)
    return (sdf.reshape(*shape, 1), feats.reshape(*shape, HID), grad.reshape(*shape, 3))


# ---------------------------------------------------------------------------
# the least work the function needs (for the bound beside the kernel time)
# ---------------------------------------------------------------------------

def _kn(multires: int) -> tuple:
    """(the forward's, the cotangent sweep's) in x out products a point, at
    the true (unpadded) widths of `multires`."""
    n_pe, skip_w = layout(multires).n_pe, layout(multires).skip_w
    # layers 0-7 (w4 as w4a on h3 and w4b on the PE); all 4 stacked rows need them
    hid = (n_pe * 256 + 2 * 256 * 256 + 256 * skip_w + skip_w * 256 + n_pe * 256
           + 3 * 256 * 256)
    # layer 8 (256 x 257) for the primal row; a tangent row needs only the
    # sdf column (grad = d sdf / dx), 256 x 1
    last = 256 * 257 + 3 * 256
    # the cotangents GZ @ W^T of layers 8..1 (no PE cotangent), whose layer 8
    # has the same primal/tangent split
    return 4 * hid + last, 4 * (hid - 2 * n_pe * 256) + last


def flops(n: int, backward: bool = False, multires: int = MULTIRES) -> float:
    """Tensor-core operations per call: the backward recomputes the forward,
    then the cotangent products and the weight-gradient products H^T GZ
    (as many as the forward's)."""
    kn_fwd, kn_gh = _kn(multires)
    kn = kn_fwd + kn_gh + kn_fwd if backward else kn_fwd
    return 2.0 * n * kn


def min_bytes(n: int, backward: bool = False, multires: int = MULTIRES) -> float:
    """Each input read once, each output written once (f32 points and
    cotangents, bf16 weights, f32 gradients)."""
    w = sum(r * c for r, c in layout(multires).pack_shapes)
    if backward:
        return n * (3 + 1 + 3 + 256) * 4 + w * 2 + w * 4
    return n * 3 * 4 + w * 2 + n * (1 + 3 + 256) * 4
