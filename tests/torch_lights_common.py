"""What the light kernel's CPU tests share (tests/test_torch_lights_bwd.py,
tests/test_torch_lights_fwd.py): the inputs made from a seed, and the
kernel's rounding points in plain torch. The 4-layer head is
torch_shader_common's `_kernel_head` (bf16 X, H and GZ, f32 sums, f32
biases: csrc/lights.cu rounds as csrc/shader.cu does); the IDE, the sphere
exit point and the reflection are evaluated with the kernel's own fused
multiply-adds, since the degree-5 IDE's rounding noise moves with the last
bit of its input. Imported by its own name, as torch_shader_common is: the
card's machine has another top-level `tests` package."""
import jax
import numpy as np
import torch

from nero_tpu.fields import mc_shading as J
from nero_tpu_torch.fields import mc_shading as T
from nero_tpu_torch.ops import lights as L
from nero_tpu_torch.ops.mlp import resolve_weight_norm
from nero_tpu_torch.utils.encodings import ide_tables, positional_encode
from torch_csrc import source_constants
from torch_shader_common import _kernel_head

CASES = [("both", "direction"), ("outer", "sphere_direction"), ("both", "sphere_direction"),
         ("outer", "direction")]


def _setup(version, p=2, s=24, seed=0):
    """(JAX cfg, port cfg, numpy params, numpy inputs, cotangents); some
    points beyond radius 0.999, so the sphere_direction clamp is exercised."""
    base = dict(human_lights=False, outer_light_version=version, bf16_hidden=False)
    cfg_j, cfg_t = J.MCShadingConfig(**base), T.MCShadingConfig(**base)
    params = jax.tree_util.tree_map(np.asarray, J.init_mc_shading(jax.random.PRNGKey(seed), cfg_j))
    rng = np.random.default_rng(seed + 1)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    dirs = f(p, s, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    inputs = (rng.uniform(-0.62, 0.62, (p, s, 3)).astype(np.float32), dirs,
              rng.uniform(-0.6, 0.6, (p, s, 3)).astype(np.float32), f(p, s, 3))
    return cfg_j, cfg_t, params, inputs, (f(p, s, 3), f(p, s, 3))


def _fma(a, b, c):
    """fmaf(a, b, c) of f32 tensors: the product is exact in f64, so only the
    sum rounds (to f64, then to f32; the two differ from one rounding only at
    a tie, about 2^-29 of the operations)."""
    return (a.double() * b.double() + c.double()).float()


class _KernelIDE(torch.autograd.Function):
    """The IDE (degree 5, kappa = 0) of xyz [n, 3] as csrc/encode.cuh
    evaluates it, with the fused multiply-adds nvcc makes of it (equal to
    the card's results to the bit: `test_cuda_encodings_are_the_emulations`
    holds them there): ide_powers' recurrences re' =
    fma(re, x, -im y), im' = fma(re, y, im x); pz = sum_k z^k c_k as one
    fused multiply-add a term from k = 0 (ide_row), and in the backward
    dpz = sum_k (k z^(k-1)) c_k the same way (ide_row_bwd). The degree-16
    polynomials cancel heavily near the poles: summed in another order (the
    matmul of `integrated_dir_encode`) pz moves by up to 5e-3, and the
    gradients of a head on it by 4e-4 of cosine; the rounding noise moves
    with the last bit of the input."""

    @staticmethod
    def _terms(xyz):
        m_arr, _, mat_np, l_max = ide_tables(5)
        mat = torch.as_tensor(mat_np, device=xyz.device)
        x, y, z = xyz[:, 0:1], xyz[:, 1:2], xyz[:, 2:3]
        re, im, zp = [torch.ones_like(x)], [torch.zeros_like(x)], [torch.ones_like(x)]
        for _ in range(l_max):
            re, im = re + [_fma(re[-1], x, -(im[-1] * y))], im + [_fma(re[-1], y, im[-1] * x)]
            zp.append(zp[-1] * z)
        pz = dpz = torch.zeros(len(xyz), mat.shape[1], device=xyz.device)
        for k in range(l_max + 1):
            pz = _fma(zp[k], mat[k], pz)
            if k:
                dpz = _fma(k * zp[k - 1], mat[k], dpz)
        return m_arr, re, im, pz, dpz

    @staticmethod
    def forward(ctx, xyz):
        ctx.save_for_backward(xyz)
        m_arr, re, im, pz, _ = _KernelIDE._terms(xyz)
        return torch.cat([torch.cat([re[m] for m in m_arr], -1) * pz,
                          torch.cat([im[m] for m in m_arr], -1) * pz], -1)

    @staticmethod
    def backward(ctx, g):
        m_arr, re, im, pz, dpz = _KernelIDE._terms(ctx.saved_tensors[0])
        gr, gi = g[:, :len(m_arr)], g[:, len(m_arr):]
        col = lambda v, shift: torch.cat([v[max(m - shift, 0)] * float(m if shift else 1)
                                          for m in m_arr], -1)
        a, b = col(re, 1), col(im, 1)  # m (x + iy)^(m - 1), zero at m = 0
        gz = (gr * col(re, 0) + gi * col(im, 0)) * dpz
        gx, gy = pz * (gr * a + gi * b), pz * (-gr * b + gi * a)
        return torch.stack([gx.sum(-1), gy.sum(-1), gz.sum(-1)], -1)


def _kernel_ide(xyz, kappa_inv=0.0, deg_view=5):
    assert kappa_inv == 0.0 and deg_view == 5, \
        f"the light kernel's IDE has degree 5, not {deg_view}"
    shape = xyz.shape
    return _KernelIDE.apply(xyz.reshape(-1, 3)).reshape(*shape[:-1], -1)


def _dot3(a, b):
    """csrc/lights.cu::dot3 as nvcc contracts it: fma(a2, b2, fma(a0, b0,
    a1 b1)), and of a vector with itself fma(a0, a0, a1 a1) + a2 a2."""
    c = [a[..., k:k + 1] for k in range(3)]
    if a is b:
        return _fma(c[0], c[0], c[1] * c[1]) + c[2] * c[2]
    e = [b[..., k:k + 1] for k in range(3)]
    return _fma(c[2], e[2], _fma(c[0], e[0], c[1] * e[1]))


# square roots and quotients through f64, rounded once to f32: exact for f32
# operands, where torch's own f32 sqrt on the CPU is not
def _sqrt(v):
    return torch.sqrt(v.double()).float()


def _div(a, b):
    return (a.double() / b.double()).float()


def _kernel_sphere_exit(pts, dirs):
    """csrc/lights.cu::sphere_row's exit point, to the bit: the point pulled
    inside radius 0.999, then fma(d, dist, sp). The IDE's rounding noise
    moves with the last bit of its input, so the emulation needs the
    kernel's point, not one within an ulp of it."""
    norm = _sqrt(_dot3(pts, pts))
    sp = torch.where(norm > 0.999, _div(pts * 0.999, torch.clamp(norm, min=1e-12)), pts)
    dtx = _dot3(sp, dirs)
    root = _sqrt(torch.clamp(_fma(dtx, dtx, -_dot3(sp, sp)) + 1.0, min=0.0) + 1e-6)
    return _fma(dirs, root - dtx, sp)


def _kernel_reflection(dirs, normals):
    """csrc/lights.cu::inner_row's reflection 2 (v.n) n - v of v =
    normalize(-d) about n = normalize(normal), to the bit: encode.cuh's
    normalize3 squares as fma(a2, a2, fma(a0, a0, a1 a1)), and nvcc makes
    (v.n) n 2 - v of t = (v.n) n into fma(v.n, n, t) - v."""
    def unit(a):
        c = [a[..., k:k + 1] for k in range(3)]
        return _div(a, torch.clamp(_sqrt(_fma(c[2], c[2], _fma(c[0], c[0], c[1] * c[1]))),
                                   min=1e-12))

    n, v = unit(normals), unit(-dirs)
    nov = _dot3(v, n)
    return _fma(nov, n, nov * n) - v


def emulate_lights_bwd(params, cfg, pts, dirs, inters, normals, mode):
    """(inner_z, outer_z) of the light heads with the kernel's rounding
    points: its values are the forward kernel's, its gradients the
    backward's; differentiable to the heads' parameters, the points and the
    directions (the traced hit points and normals detached), as
    `lights_raw`. The encodings' IDE, the sphere exit point and the
    reflection are the kernel's (`_KernelIDE`, `_kernel_sphere_exit`,
    `_kernel_reflection`)."""
    ide = lambda v: _kernel_ide(v, deg_view=cfg.ide_deg)
    outer_in = ide(dirs)
    if cfg.outer_light_version == "sphere_direction":
        outer_in = torch.cat([outer_in, ide(_kernel_sphere_exit(pts, dirs))], -1)
    outer_z = _kernel_head(resolve_weight_norm(params["outer_light"]), outer_in)
    if mode == "outer":
        return torch.zeros_like(outer_z), outer_z
    inner_in = torch.cat([positional_encode(inters.detach(), L.INNER_POS_FREQ),
                          ide(_kernel_reflection(dirs, normals.detach()))], -1)
    return _kernel_head(resolve_weight_norm(params["inner_light"]), inner_in), outer_z


_NAMES = {"encode.cuh": ("NML", "LMAX", "TAB"),
          "engine.cuh": ("LAYER_W", "WN", "NQ", "SLAB_K", "LDB", "LDT", "STAGES", "HS", "PW_RS",
                         "PW_MIN_ROWS", "PW_MAX_CHUNKS"),
          "lights.cu": ("HID", "DO", "PB", "BTHREADS", "LDA", "RSB", "DI_INNER", "DI_OUTER",
                        "DI_OUTER_SPH")}


def _source_constants(ide_deg: int = 5) -> dict:
    """The constants of csrc/lights.cu and the headers it runs on, as the
    sources hold them, at the build of IDE degree `ide_deg`."""
    c = source_constants(tuple(_NAMES), [n for names in _NAMES.values() for n in names],
                         {"NERO_IDE_DEG": ide_deg})
    c["STAGE_ELEMS"] = max(c["SLAB_K"] * c["LDB"], c["LAYER_W"] * c["LDT"])
    return c
