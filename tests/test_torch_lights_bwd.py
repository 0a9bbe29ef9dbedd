"""The light kernel's backward (csrc/lights.cu: recompute and reverse sweep,
parameter pass, reduction) as far as the CPU can hold it: its rounding
points emulated in plain torch (torch_lights_common.py's
`emulate_lights_bwd`: bf16 X, H and GZ, f32
sums, the input cotangent dX = GZ1 W1^T in f32 and the encodings' backward
in f32; the IDE, the sphere exit point and the reflection with the kernel's
own fused multiply-adds, since the degree-5 IDE's rounding noise moves with
the last bit of its input) against the port's f32 plain gradients and
nero_tpu's XLA gradients of the unfused light path, in both modes and both
outer-light versions, at chip_smoke.py's bars: cosine > 0.99 per parameter
leaf and > 0.98 for d directions and d points. Also the zero-row case of the wrapper, a mirror
of the backward's buffer sizes against the constants of the sources, and the
patches of `nero_tpu_torch/kernel_variants.py --kernel lights`. The kernel
itself is held against its plain version and this emulation on the card by
the `gpu`-marked test and by chip_smoke.py."""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nero_tpu.fields import mc_shading as J
from nero_tpu_torch import kernel_variants
from nero_tpu_torch.core.convert import from_numpy_tree, tree_items
from nero_tpu_torch.ops import cuda_build
from nero_tpu_torch.ops import lights as L
from nero_tpu_torch.ops.mlp import exp_activation
from nero_tpu_torch.utils.encodings import integrated_dir_encode
from torch_lights_common import (CASES, _kernel_ide, _kernel_reflection, _kernel_sphere_exit,
                                 _setup, _source_constants, emulate_lights_bwd)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the backward's rounding points
# ---------------------------------------------------------------------------


def _port_grads(fn, cfg_t, params, inputs, cots, mode):
    """Gradients of the activated lights against the cotangents, over the
    evaluated heads' leaves, then d points and d directions."""
    p = from_numpy_tree(params)
    heads = {k: p[k] for k in ("inner_light", "outer_light")[mode == "outer":]}
    pts, dirs = (torch.from_numpy(a).requires_grad_(True) for a in inputs[:2])
    inner_z, outer_z = fn(p, cfg_t, pts, dirs, *map(torch.from_numpy, inputs[2:]), mode)
    loss = ((exp_activation(inner_z, cfg_t.inner_light_exp_max) * torch.from_numpy(cots[0])).sum()
            + (exp_activation(outer_z, cfg_t.light_exp_max) * torch.from_numpy(cots[1])).sum())
    leaves = [v for _, v in tree_items(heads)]
    g = torch.autograd.grad(loss, leaves + [pts, dirs], allow_unused=True)
    return [np.zeros(tuple(x.shape), np.float32) if gi is None else gi.numpy()
            for x, gi in zip(leaves + [pts, dirs], g)], len(leaves)


def _jax_grads(cfg_j, params, inputs, cots, mode):
    names = ("inner_light", "outer_light")[mode == "outer":]
    inters, normals = map(jnp.asarray, inputs[2:])

    def loss(heads, p, d):
        pj = {**params, **heads}
        outer = J.predict_outer_lights(pj, cfg_j, p, d)
        total = jnp.sum(outer * cots[1])
        if mode == "both":
            total += jnp.sum(J.get_inner_lights(pj, cfg_j, inters, -d, normals) * cots[0])
        return total
    g = jax.grad(loss, argnums=(0, 1, 2))({k: params[k] for k in names},
                                         *map(jnp.asarray, inputs[:2]))
    gh = jax.tree_util.tree_map(np.asarray, g[0])
    return [a for _, a in tree_items(gh)] + [np.asarray(g[1]), np.asarray(g[2])]


def _cosines(ga, gb):
    out = []
    for a, b in zip(ga, gb):
        a, b = a.ravel(), b.ravel()
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        out.append(float(a @ b / denom) if denom >= 1e-12 else 1.0)
    return out


@pytest.mark.parametrize("reference", ["plain", "xla"])
@pytest.mark.parametrize("mode,version", CASES)
def test_rounding_points_hold_the_bar(mode, version, reference):
    """Every parameter leaf within cosine 0.99, d points and d directions
    within 0.98, of the f32 gradients of the port's plain version or of
    nero_tpu's unfused XLA path."""
    cfg_j, cfg_t, params, inputs, cots = _setup(version)
    got, n_par = _port_grads(emulate_lights_bwd, cfg_t, params, inputs, cots, mode)
    if reference == "xla":
        want = _jax_grads(cfg_j, params, inputs, cots, mode)
    else:
        want, _ = _port_grads(L.lights_raw_plain, cfg_t, params, inputs, cots, mode)
    cos = _cosines(want, got)
    assert min(cos[:n_par]) > 0.99, (min(cos[:n_par]), int(np.argmin(cos[:n_par])))
    assert min(cos[n_par:]) > 0.98, cos[n_par:]
    # d points is zero without the sphere hit (the inner head's PE8 input is detached)
    assert (np.abs(want[-2]).max() > 0) == (version == "sphere_direction")
    # the emulation is no copy of the reference: bf16 moves every leaf a little
    assert max(float(np.abs(a - b).max()) for a, b in zip(want, got)) > 0.0


@pytest.mark.parametrize("mode", ["both", "outer"])
def test_zero_rows_give_zero_parameter_gradients(mode):
    """No rows: empty outputs and every parameter gradient exactly 0 (the CPU
    side of the wrapper; on the card nothing is launched and dW, dB stay
    zero)."""
    _, cfg_t, params, _, _ = _setup("sphere_direction")
    p = from_numpy_tree(params)
    z = torch.zeros(0, 3)
    inner_z, outer_z = L.lights_raw(p, cfg_t, z, z, z, z, mode)
    assert inner_z.shape == outer_z.shape == (0, 3)
    leaves = [v for _, v in tree_items(p)]
    grads = torch.autograd.grad(inner_z.sum() + outer_z.sum(), leaves, allow_unused=True)
    assert all(g is None or not g.any() for g in grads)


def _unit_directions(n_all, n_poles, seed=0):
    """Unit vectors, n_poles of them within about 0.01 of the z axis, where
    the IDE's degree-16 polynomials cancel most."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n_all, 3))
    v[:n_poles, :2] *= 1e-2
    return torch.tensor(v / np.linalg.norm(v, axis=-1, keepdims=True), dtype=torch.float32)


def test_kernel_ide_is_the_ide():
    """`_KernelIDE` is the IDE of `integrated_dir_encode` to f32 rounding:
    against the f64 IDE its largest and its mean error are within 1.5x the
    f32 `integrated_dir_encode`'s own, and its hand-derived backward is the
    f64 gradient within cosine 0.99999 and 2e-3 of the largest entry. Other
    degrees are refused, as the kernel has only degree 5."""
    x = _unit_directions(20000, 2000)
    want = integrated_dir_encode(x.double(), 0.0, 5)
    err = (_kernel_ide(x).double() - want).abs()
    err_f32 = (integrated_dir_encode(x, 0.0, 5).double() - want).abs()
    assert err.max() <= 1.5 * err_f32.max() and err.mean() <= 1.5 * err_f32.mean(), (
        err.max().item(), err_f32.max().item(), err.mean().item(), err_f32.mean().item())
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(tuple(want.shape)))
    xk, xd = x.clone().requires_grad_(True), x.double().requires_grad_(True)
    gk = torch.autograd.grad((_kernel_ide(xk) * g.float()).sum(), xk)[0].double()
    gd = torch.autograd.grad((integrated_dir_encode(xd, 0.0, 5) * g).sum(), xd)[0]
    cos = float(gk.flatten() @ gd.flatten() / (gk.norm() * gd.norm()))
    rel = ((gk - gd).abs().max() / gd.abs().max()).item()
    assert cos > 0.99999 and rel < 2e-3, (cos, rel)
    with pytest.raises(AssertionError, match="degree 5"):
        _kernel_ide(x, deg_view=4)


# ---------------------------------------------------------------------------
# the backward's buffers: a mirror of csrc/lights.cu's layout
# ---------------------------------------------------------------------------


def backward_sizes(n: int, sphere: bool, both: bool) -> tuple:
    """(bf16 elements of the scratch, floats of the partials) for n rows: X,
    H and GZ of layers 1-3 and GZ4 (16 wide) of every evaluated head for n
    rounded up to the parameter pass's stage; one dW + dB per row chunk."""
    c = _source_constants()
    heads = L.HEAD_ORDER if both else L.HEAD_ORDER[1:]
    pads = [L.DI_PAD["outer_light_sphere" if h == "outer_light" and sphere else h] for h in heads]
    m = -(-n // c["PW_RS"]) * c["PW_RS"]
    scratch = m * sum(pads) + len(heads) * m * (6 * 256 + 16)
    chunks = min(max(m // c["PW_MIN_ROWS"], 1), c["PW_MAX_CHUNKS"])
    return scratch, chunks * (L.weight_elems(sphere, both) + len(heads) * 4 * 256)


@pytest.mark.parametrize("sphere,both", [(False, True), (True, False), (True, True),
                                         (False, False)])
def test_backward_buffer_sizes(sphere, both):
    """The mirror at n = 1, 1001, 393,216: the tile and chunk constants the
    sources hold, and the sizes they give (2.61 GB of scratch at 393,216
    rows in mode `both`, 6.6 KB a row)."""
    c = _source_constants()
    assert c["PB"] == L.TILE == 128 and c["PW_RS"] % c["PB"] == 0
    x_row = (128 if both else 0) + (144 if sphere else 80)
    heads = 2 if both else 1
    for n, m, chunks in ((1, 128, 1), (1001, 1024, 1), (393216, 393216, 64)):
        scratch, part = backward_sizes(n, sphere, both)
        assert scratch == m * (x_row + heads * 1552)
        assert part == chunks * (L.weight_elems(sphere, both) + heads * 1024)
    if both and not sphere:
        assert abs(backward_sizes(393216, False, True)[0] * 2 / 1e9 - 2.605) < 0.001


@pytest.mark.parametrize("name", list(kernel_variants.LIGHTS_VARIANTS))
def test_every_variant_patch_applies(name):
    """A stale patch shows only on the card: each variant's every (old, new)
    pair must find its text in csrc/lights.cu as it is, and change it."""
    src = kernel_variants.variant_source(name, "lights")
    with open(os.path.join(cuda_build.CSRC, "lights.cu")) as f:
        orig = f.read()
    assert (src == orig) == (not kernel_variants.LIGHTS_VARIANTS[name])


def _c_entries():
    """name -> argument count of every C entry of csrc/lights.cu."""
    with open(os.path.join(cuda_build.CSRC, "lights.cu")) as f:
        src = f.read()
    block = src[src.index('extern "C" {'):]
    return {m.group(1): len([a for a in m.group(2).split(",") if a.strip()])
            for m in re.finditer(r"^(?:int|size_t) (lights_\w+)\(([^)]*)\)", block, re.M)}


@pytest.mark.parametrize("parts", [True, False])
def test_one_typing_covers_every_c_entry(parts):
    """`ops/lights.py::type_lib` (the wrapper's and kernel_variants' one
    typing) gives every C entry of csrc/lights.cu as many arguments as the
    source declares, and says whether the library has the backward's two
    parts; a library without them (an earlier source) is typed all the
    same."""
    entries = _c_entries()
    split = ("lights_bwd_sweep", "lights_bwd_params")
    assert set(split) <= set(entries)
    lib = type("Lib", (), {})()
    for name in entries:
        if parts or name not in split:
            setattr(lib, name, type("Fn", (), {})())
    assert L.type_lib(lib) is parts
    for name, n_args in entries.items():
        if hasattr(lib, name):
            assert len(getattr(lib, name).argtypes) == n_args, name


def test_the_kernel_takes_its_weight_gradients_from_its_own_pass():
    """Three launches (sweep, parameter pass, reduction) in place of the
    rows kernel and 16 reductions: csrc/lights.cu calls no common.cuh
    weight_grad / bias_grad."""
    with open(os.path.join(cuda_build.CSRC, "lights.cu")) as f:
        src = f.read()
    assert "weight_grad(" not in src and "bias_grad(" not in src
    for k in ("lights_bwd_sweep_kernel", "lights_bwd_params_kernel", "lights_bwd_reduce_kernel"):
        assert f"{k}<L><<<" in src


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("mode,version", CASES)
def test_cuda_backward_matches_plain_and_emulation(mode, version):
    """n = 1001 (ragged for both tiles) and 0: the kernel's gradients against
    the plain version (cosine 0.99 per parameter leaf, 0.98 d points and
    d directions) and against the emulated rounding points (0.9999); the
    library's buffer sizes equal the mirror; two backward calls give the
    same dW, dB and dgeo to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    _, cfg_t, params, inputs, cots = _setup(version, p=7, s=143)
    n = 1001
    sphere, both = version == "sphere_direction", mode == "both"
    lib = L._lib()
    for m in (1, 1001, 393216):
        assert (lib.lights_scratch_elems(m, int(sphere), int(both)),
                lib.lights_part_elems(m, int(sphere), int(both))) == backward_sizes(m, sphere,
                                                                                    both)
    p = from_numpy_tree(params, device=dev)
    xs = [torch.from_numpy(a).to(dev).reshape(n, 3) for a in inputs]
    gout = torch.from_numpy(np.concatenate(cots, -1)).to(dev).reshape(n, 6)
    with torch.no_grad():
        geo, _, _, ws, bs = L.kernel_inputs(p, cfg_t, *xs, mode)
        W, B = L.pack_buffers(ws, bs, sphere, both)
        got = L._bwd(geo, W, B, sphere, both, gout)
        again = L._bwd(geo, W, B, sphere, both, gout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    heads = {k: p[k] for k in L.HEAD_ORDER[not both:]}
    leaves = [v for _, v in tree_items(heads)]
    dws, dbs = L.unpack_grads(got[1], got[2], [tuple(w.shape) for w in ws], sphere, both)
    # the kernel's dW, dB to the parameter leaves through the weight norm,
    # resolved again with autograd on (the launches above ran without it)
    ws_g, bs_g = L.kernel_inputs(p, cfg_t, *xs, mode)[3:]
    mine = list(torch.autograd.grad(ws_g + bs_g, leaves, dws + dbs)) + [got[0][:, 0:3],
                                                                        got[0][:, 3:6]]
    for fn, bars in ((L.lights_raw_plain, (0.99, 0.98)), (emulate_lights_bwd, (0.9999, 0.9999))):
        xg = [x.clone().requires_grad_(i < 2) for i, x in enumerate(xs)]
        raw = torch.cat(fn(p, cfg_t, *xg, mode), -1)
        want = torch.autograd.grad(raw, leaves + xg[:2], gout, allow_unused=True)
        want = [torch.zeros_like(b) if a is None else a for a, b in zip(want, mine)]
        cos = _cosines([a.cpu().numpy() for a in want], [b.cpu().numpy() for b in mine])
        assert min(cos[:len(leaves)]) > bars[0] and min(cos[len(leaves):]) > bars[1], cos
    counted = dict(L.launches)
    z = L._bwd(geo[:0], W, B, sphere, both, gout[:0])
    assert z[0].shape == (0, 6) and not z[1].any() and not z[2].any()
    assert L._fwd(geo[:0], W, B, sphere, both).shape == (0, 6)
    assert L.launches == counted  # no rows, no launch, no count


_PROBE = r"""
#include "lights.cu"

// csrc/lights.cu's row geometry and encode.cuh's IDE, forward and backward,
// one row a thread: the exit point of sphere_row, the reflection of
// inner_row, and the IDE of the direction, the exit point and the reflection
__global__ void encodings_probe(const float* p, const float* d, const float* nrm,
                                const float* tab, const float* g, int n, float* hp, float* refl,
                                float* ide, float* dxyz) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  SphereRow h;
  sphere_row(p + 3 * i, d + 3 * i, h);
  float nn[3], vv[3], vlen, r[3];
  inner_row(nrm + 3 * i, d + 3 * i, nn, vv, &vlen, r);
  for (int k = 0; k < 3; ++k) { hp[3 * i + k] = h.hp[k]; refl[3 * i + k] = r[k]; }
  const float* v[3] = {d + 3 * i, h.hp, r};
  for (int j = 0; j < 3; ++j) {
    const size_t row = (size_t)j * n + i;
    ide_row(tab, v[j][0], v[j][1], v[j][2], 0.0f, ide + row * NIDE, 1);
    float dv[3] = {0.0f, 0.0f, 0.0f};
    ide_row_bwd(tab, v[j][0], v[j][1], v[j][2], 0.0f, g + row * NIDE, dv);
    for (int k = 0; k < 3; ++k) dxyz[row * 3 + k] = dv[k];
  }
}

extern "C" int encodings_probe_run(const float* p, const float* d, const float* nrm,
                                   const float* tab, const float* g, int n, float* hp,
                                   float* refl, float* ide, float* dxyz) {
  encodings_probe<<<(n + 127) / 128, 128>>>(p, d, nrm, tab, g, n, hp, refl, ide, dxyz);
  return (int)cudaDeviceSynchronize();
}
"""


@pytest.mark.gpu
def test_cuda_encodings_are_the_emulations():
    """The emulation's encodings are the kernel's, compiled from csrc/lights.cu
    as it stands: the sphere exit point (`_kernel_sphere_exit`), the
    reflection (`_kernel_reflection`) and the IDE (`_kernel_ide`) of the
    directions, exit points and reflections equal to the bit; the IDE's
    backward within 1e-6 of its largest entry (it sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import ctypes
    import subprocess

    out_dir = os.path.join(cuda_build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = (os.path.join(out_dir, "encodings_probe" + ext) for ext in (".cu", ".so"))
    with open(cu, "w") as f:
        f.write(_PROBE)
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", cuda_build.CSRC, "-o", so,
                    cu], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    vp = ctypes.c_void_p
    lib.encodings_probe_run.argtypes = [vp] * 5 + [ctypes.c_int] + [vp] * 4
    dev = torch.device("cuda")
    _, _, _, inputs, _ = _setup("sphere_direction", p=7, s=143)
    p, d, _, nrm = (torch.from_numpy(a).reshape(-1, 3).to(dev).contiguous() for a in inputs)
    n = len(p)
    g = torch.randn(3 * n, 72, device=dev, generator=torch.Generator(dev).manual_seed(0))
    hp, refl = torch.empty(n, 3, device=dev), torch.empty(n, 3, device=dev)
    ide, dv = torch.empty(3 * n, 72, device=dev), torch.empty(3 * n, 3, device=dev)
    assert lib.encodings_probe_run(*(t.data_ptr() for t in (p, d, nrm, L.ide_table_on(dev), g)),
                                   n, *(t.data_ptr() for t in (hp, refl, ide, dv))) == 0
    v = torch.cat([d, hp, refl])
    vg = v.clone().requires_grad_(True)
    dv_e = torch.autograd.grad((_kernel_ide(vg) * g).sum(), vg)[0]
    unequal = {"exit point rows": int((_kernel_sphere_exit(p, d) != hp).any(-1).sum()),
               "reflection rows": int((_kernel_reflection(d, nrm) != refl).any(-1).sum()),
               "IDE entries": int((_kernel_ide(v) != ide).sum())}
    rel = ((dv_e - dv).abs().max() / dv.abs().max()).item()
    assert not any(unequal.values()) and rel < 1e-6, (unequal, rel)
