"""The light kernel's backward (csrc/lights.cu: recompute and reverse sweep,
parameter pass, reduction) as far as the CPU can hold it: its rounding
points emulated in plain torch (`emulate_lights_bwd`: bf16 X, H and GZ, f32
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
from nero_tpu_torch.fields import mc_shading as T
from nero_tpu_torch.ops import cuda_build
from nero_tpu_torch.ops import lights as L
from nero_tpu_torch.ops.mlp import exp_activation, resolve_weight_norm
from nero_tpu_torch.utils.encodings import ide_tables, integrated_dir_encode, positional_encode

torch.set_num_threads(1)

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


# ---------------------------------------------------------------------------
# the backward's rounding points
# ---------------------------------------------------------------------------


def _bf(x):
    return x.to(torch.bfloat16).float()


class _KernelHead(torch.autograd.Function):
    """One 4-layer head as the kernel rounds it: the recompute's bf16 input X
    and activations H = bf16(relu(X W + b)) with f32 sums; the sweep's GZ4 =
    bf16(cotangent), GZ = bf16(mask(H) * (GZ W^T)), dX = GZ1 W1^T in f32; the
    parameter pass's dW = X^T GZ and db = sum GZ in f32."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w3, b3, w4, b4):
        shape = x.shape[:-1]
        xb = _bf(x.reshape(-1, x.shape[-1]))
        ws = [_bf(w) for w in (w1, w2, w3, w4)]
        hs, h = [], xb
        for w, b in zip(ws[:3], (b1, b2, b3)):
            h = _bf(torch.relu(h @ w + b))
            hs.append(h)
        ctx.save_for_backward(xb, *hs, *ws)
        ctx.shape = shape
        return (h @ ws[3] + b4).reshape(*shape, -1)

    @staticmethod
    def backward(ctx, g):
        xb, h1, h2, h3, w1, w2, w3, w4 = ctx.saved_tensors
        gz4 = _bf(g.reshape(-1, g.shape[-1]))
        gz3 = _bf((gz4 @ w4.T) * (h3 > 0))
        gz2 = _bf((gz3 @ w3.T) * (h2 > 0))
        gz1 = _bf((gz2 @ w2.T) * (h1 > 0))
        return ((gz1 @ w1.T).reshape(*ctx.shape, -1), xb.T @ gz1, gz1.sum(0), h1.T @ gz2,
                gz2.sum(0), h2.T @ gz3, gz3.sum(0), h3.T @ gz4, gz4.sum(0))


def _kernel_head(layers, x):
    return _KernelHead.apply(x, *[l[k] for l in layers for k in ("w", "b")])


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
    points in their backward; differentiable to the heads' parameters, the
    points and the directions (the traced hit points and normals detached),
    as `lights_raw`. The encodings' IDE, the sphere exit point and the
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


def _source_constants() -> dict:
    out = {}
    for fn, keys in (("lights.cu", ("PB",)),
                     ("engine.cuh", ("PW_RS", "PW_MIN_ROWS", "PW_MAX_CHUNKS"))):
        with open(os.path.join(cuda_build.CSRC, fn)) as f:
            src = f.read()
        out.update({k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                    for k in keys})
    return out


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
    assert c["PB"] == L.BWD_TILE == 128 and c["PW_RS"] % c["PB"] == 0
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
    split = ("lights_bwd_sweep", "lights_bwd_params", "lights_bwd_tile")
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
