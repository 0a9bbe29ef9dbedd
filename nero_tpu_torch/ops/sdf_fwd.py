"""SDF value without gradient: the CUDA kernel and its plain version.

Replaces nero_tpu/ops/pallas/sdf_kernel.py::sdf_fwd_fused (:148, pallas_call
nero_sdf_fwd :122). The kernel source is csrc/sdf_fwd.cu; its header comment
gives the design. It serves Stage I's no-gradient callers (proposal sampler,
occlusion march, validation march) when `use_fused_sdf` is set. `sdf_fwd`
launches the kernel for a CUDA tensor and runs `sdf_fwd_plain` (the f32
`sdf_value`) for a CPU tensor, and only then. Weight norm is folded when the
weights are packed; nothing here is differentiable.

It takes the SDFs that nero_tpu's value-only kernel takes (8 layers of 256
with the skip at 4, weight norm, multires 1-20: `supported`), on the same
library specialisations as the SDF-with-gradient kernel (ops/sdf_grad.py::
layout); of the last layer it reads the sdf column alone, so any d_out.

What bounds it on the card: tensor-core operations (`flops`), 0.92 MFLOP a
point at multires 6 against 16 bytes a point; the kernel uses bf16 operands with f32 sums,
so its values carry ~1e-2 of noise against the f32 network (the JAX
kernel's test bar is atol 2e-2).

`make_sdf_fwd_scenes_fn` is the same function over S scenes' SDFs stacked on
a leading axis (parallel/scenes.py), as nero_tpu's `jax.vmap` of the
multi-scene step batches the pallas_call: one launch for all scenes, on a
grid with a scene dimension, the rows scene-major with n a scene; each
scene's values are its one-scene launch's to the bit. On CPU tensors it runs
`sdf_fwd_plain` scene by scene.
"""
from __future__ import annotations

import ctypes
import math

import torch

from nero_tpu_torch.fields.sdf import SDFConfig, sdf_value
from nero_tpu_torch.ops import cuda_build
from nero_tpu_torch.ops.mlp import resolve_weight_norm
from nero_tpu_torch.ops.sdf_grad import (MULTIRES, PACK_SHAPES, counter, defines, layout,
                                         pack_weights, topology_supported)
from nero_tpu_torch.parallel.scenes import n_scenes as count_scenes, scene_slice

TILE, SMALL_TILE = 128, 64  # points per block (csrc/sdf_fwd.cu Tile<2>, Tile<1>)

# per multires: `sdf_fwd` at 6, `sdf_fwd_m<multires>` at another (added at its first launch)
# (`_scenes`: one launch for all scenes of the multi-scene step)
launches = {"sdf_fwd": 0, "sdf_fwd_scenes": 0}
# FLOPs of every counted launch, by `flops(...)` at the launch's shapes (core/mfu.py)
flop_tally = dict.fromkeys(launches, 0.0)


def tile(n: int, sms: int) -> int:
    """Points a block at n points on a card of `sms` SMs, csrc/sdf_fwd.cu's
    rule (its C entry `sdf_fwd_tile`): SMALL_TILE when the launch is one
    wave of SMALL_TILE-point blocks, else TILE."""
    return SMALL_TILE if -(-n // SMALL_TILE) <= sms else TILE


@torch.no_grad()
def sdf_fwd_plain(params, x: torch.Tensor, cfg: SDFConfig = SDFConfig()) -> torch.Tensor:
    """[..., 3] -> [..., 1] signed distance in plain f32 torch, detached."""
    return sdf_value(params, x.detach(), cfg)


def supported(cfg: SDFConfig) -> bool:
    return topology_supported(cfg)


def _lib(multires: int = MULTIRES):
    lib = cuda_build.load("sdf_fwd", defines(multires))
    if not getattr(lib, "_nero_typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sdf_fwd_weight_elems.restype = ctypes.c_size_t
        lib.sdf_fwd_weight_elems.argtypes = []
        lib.sdf_fwd.restype = i
        lib.sdf_fwd.argtypes = [vp, i, vp, vp, f, f, vp, vp]
        # S scenes in one launch: n a scene, then S
        lib.sdf_fwd_scenes.restype = i
        lib.sdf_fwd_scenes.argtypes = [vp, i, i, vp, vp, f, f, vp, vp]
        lib.sdf_fwd_tile.restype, lib.sdf_fwd_tile.argtypes = i, [i, i]
        if lib.sdf_fwd_weight_elems() != sum(r * c for r, c in layout(multires).pack_shapes):
            raise RuntimeError("csrc/sdf_fwd.cu layout differs from ops/sdf_grad.py")
        if any(lib.sdf_fwd_tile(n, 132) != tile(n, 132) for n in (1, 8448, 8449)):
            raise RuntimeError("csrc/sdf_fwd.cu's tile rule differs from ops/sdf_fwd.py")
        lib._nero_typed = True
    return lib


@torch.no_grad()
def pack_params(params, cfg: SDFConfig = SDFConfig()):
    """{v,g,b} or resolved layers -> (packed bf16 weights, bias f32 [9, 272]):
    the layout of the SDF-with-gradient kernel, weight norm folded; of the
    last layer the sdf column (the kernel reads no other)."""
    if not supported(cfg):
        raise NotImplementedError(f"the sdf_fwd kernel needs 8 x 256 layers with the skip at 4, "
                                  f"weight norm and multires 1-20; got {cfg}")
    layers = resolve_weight_norm(params)
    ws = [l["w"].detach() for l in layers]
    bs = [l["b"].detach() for l in layers]
    return pack_weights(ws[:8] + [ws[8][:, :1]], bs[:8] + [bs[8][:1]])


@torch.no_grad()
def pack_scenes(params, cfg: SDFConfig = SDFConfig()):
    """S scenes' SDFs stacked on a leading axis ({v,g,b} or resolved layers,
    [S, ...] each) -> (packed bf16 [S, W_TOTAL], bias f32 [S, 9, 272]), each
    scene packed as one scene's is."""
    packs = [pack_params(scene_slice(params, s), cfg)
             for s in range(count_scenes({"sdf": params}))]
    return (torch.stack([p[0] for p in packs]).contiguous(),
            torch.stack([p[1] for p in packs]).contiguous())


def _launch(W, bias, pts, cfg: SDFConfig):
    """One launch on packed weights, for one scene (pts [n, 3], W [W_TOTAL],
    bias [9, 272]) or for S (a leading scene axis on each): -> sdf [..., n].
    A launch for scenes counts under `sdf_fwd_scenes`."""
    m = cfg.multires
    lead, n = pts.shape[:-2], pts.shape[-2]
    S = math.prod(lead)
    out = torch.empty(lead + (n,), device=pts.device)
    rc = _lib(m).sdf_fwd_scenes(pts.data_ptr(), n, S, W.data_ptr(), bias.data_ptr(),
                                float(cfg.beta), float(cfg.scale), out.data_ptr(),
                                torch.cuda.current_stream(pts.device).cuda_stream)
    name = "sdf_fwd" + ("_scenes" if lead else "")
    cuda_build.check(rc, name)
    if n and S:  # the C entry launches nothing for no rows
        key = counter(name, m)
        launches[key] = launches.get(key, 0) + 1
        flop_tally[key] = flop_tally.get(key, 0.0) + flops(S * n, m)
    return out


@torch.no_grad()
def sdf_fwd_packed(packed, x: torch.Tensor, cfg: SDFConfig = SDFConfig()) -> torch.Tensor:
    """The kernel on packed weights: x [..., 3] (CUDA) -> [..., 1]."""
    shape = x.shape[:-1]
    out = _launch(*packed, x.detach().reshape(-1, 3).float().contiguous(), cfg)
    return out.reshape(*shape, 1)


@torch.no_grad()
def sdf_fwd_scenes_packed(packed, x: torch.Tensor, n_scenes: int,
                          cfg: SDFConfig = SDFConfig()) -> torch.Tensor:
    """The kernel on S scenes' packed weights (`pack_scenes`): x [..., 3]
    (CUDA), its rows scene-major, scene s's the s-th of S equal parts of the
    leading axis -> [..., 1]."""
    shape = x.shape[:-1]
    out = _launch(*packed, x.detach().reshape(n_scenes, -1, 3).float().contiguous(), cfg)
    return out.reshape(*shape, 1)


def make_sdf_fwd_fn(params, cfg: SDFConfig = SDFConfig()):
    """x [..., 3] -> sdf [..., 1], no gradient: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor. The weights are packed once,
    at the first call on a CUDA tensor (the sampler and the marches call the
    function 2-4 times with the same weights)."""
    packed = []

    def fn(x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return sdf_fwd_plain(params, x, cfg)
        if not packed:
            packed.append(pack_params(params, cfg))
        return sdf_fwd_packed(packed[0], x, cfg)

    return fn


def sdf_fwd(params, x: torch.Tensor, cfg: SDFConfig = SDFConfig()) -> torch.Tensor:
    """One call of `make_sdf_fwd_fn(params, cfg)`."""
    return make_sdf_fwd_fn(params, cfg)(x)


def make_sdf_fwd_scenes_fn(params, n_scenes: int, cfg: SDFConfig = SDFConfig()):
    """`make_sdf_fwd_fn` of S scenes' SDFs stacked on a leading axis: x
    [..., 3] with its rows scene-major (scene s's the s-th of S equal parts
    of the leading axis) -> sdf [..., 1], no gradient. On a CUDA tensor one
    kernel launch for all scenes, the weights packed once, at the first
    call; on a CPU tensor the plain version scene by scene."""
    packed = []

    def fn(x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return torch.cat([sdf_fwd_plain(scene_slice(params, s), c, cfg)
                              for s, c in enumerate(x.chunk(n_scenes, 0))])
        if not packed:
            packed.append(pack_scenes(params, cfg))
        return sdf_fwd_scenes_packed(packed[0], x, n_scenes, cfg)

    return fn


def sdf_fwd_scenes(params, x: torch.Tensor, cfg: SDFConfig = SDFConfig()) -> torch.Tensor:
    """One call of `make_sdf_fwd_scenes_fn` on x [S, ..., 3] -> [S, ..., 1]."""
    return make_sdf_fwd_scenes_fn(params, x.shape[0], cfg)(x)


# ---------------------------------------------------------------------------
# the least work the function needs (for the bound beside the kernel time)
# ---------------------------------------------------------------------------

def flops(n: int, multires: int = MULTIRES) -> float:
    """The nine products at their true widths (w4 as w4a on h3 and w4b on
    the PE; of the last layer the sdf column alone)."""
    n_pe, skip_w = layout(multires).n_pe, layout(multires).skip_w
    kn = (n_pe * 256 + 2 * 256 * 256 + 256 * skip_w + skip_w * 256 + n_pe * 256
          + 3 * 256 * 256 + 256)
    return 2.0 * n * kn


def min_bytes(n: int, multires: int = MULTIRES) -> float:
    """Points read once, one float a point written, bf16 weights read once."""
    return n * 3 * 4 + n * 4 + sum(r * c for r, c in layout(multires).pack_shapes) * 2
