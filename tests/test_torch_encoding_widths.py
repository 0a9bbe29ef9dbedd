"""The TPU kernels' other encoding widths in the port: the SDF kernels (B1
with its gradient, B6 value-only) at multires 1-20, the light kernel (B5) at
IDE degrees 1-4, and the gates, FLOP tallies and shared-memory layouts of
every width the kernels take. (The whole-shader kernel's widths:
tests/test_torch_encoding_widths_shader.py; two training steps of each stage
at the new widths: tests/test_torch_encoding_widths_e2e.py.)

On the CPU each wrapper runs its plain version; these tests hold it, the
kernels' packed layouts and an emulation of B1's forward on its packed
weights (bf16 operands, f32 sums, as csrc/sdf_grad.cu rounds) against
nero_tpu's Pallas kernels in interpret mode, at the tolerances of their own
tests (B1 below multires 6 against nero_tpu's XLA path: its kernel's layer-3
mask is fixed at multires 6's width, `_reference_b1`). The SDF's PE weights, zero under the geometric init, are drawn at
0.01, so that every PE channel reaches the outputs. The CUDA kernels are held
against the plain versions on the card by chip_smoke.py at the same widths."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nero_tpu.fields import mc_shading as JM
from nero_tpu.fields.app_shading import AppShadingConfig as JShCfg, fused_shader_supported
from nero_tpu.fields.sdf import SDFConfig as JSDFConfig, init_sdf
from nero_tpu.fields.sdf import sdf_with_grad as jax_sdf_with_grad
from nero_tpu.ops.mlp import exp_activation as exp_jax
from nero_tpu.ops.pallas.interp import force_interpret
from nero_tpu.ops.pallas.light_kernel import lights_fused_raw
from nero_tpu.ops.pallas.sdf_grad_kernel import (PE_PAD, pack_sdf_grad_params,
                                                 sdf_with_grad_fused)
from nero_tpu.ops.pallas.sdf_kernel import pack_sdf_params, sdf_fwd_fused
from nero_tpu.render import shape as JR
from nero_tpu_torch.core.convert import from_numpy_tree, tree_items
from nero_tpu_torch.fields import mc_shading as TM
from nero_tpu_torch.fields.app_shading import AppShadingConfig
from nero_tpu_torch.fields.sdf import SDFConfig
from nero_tpu_torch.ops import lights as L
from nero_tpu_torch.ops import sdf_fwd as S
from nero_tpu_torch.ops import sdf_grad as G
from nero_tpu_torch.ops import shader as Sh
from nero_tpu_torch.ops.mlp import exp_activation, resolve_weight_norm
from nero_tpu_torch.render import shape as TR
from nero_tpu_torch.utils.encodings import ide_dim
from torch_csrc import source_constants

torch.set_num_threads(1)

MULTIRES = (1, 4, 8, 10)
N_PTS = 48
SMEM_MAX = 232448  # a block's shared memory on the H100


def _bf(x):
    return x.to(torch.bfloat16).float()


def _live_pe(params, m: int, seed: int = 4):
    """numpy SDF params with the PE's weights (layer 0's PE rows, the skip
    layer's PE rows: zero under the geometric init) drawn at 0.01 / 2^i for
    octave i (kernel_variants.py::sdf_params' rule), so that each octave
    moves the spatial gradient about as much as the first."""
    rng = np.random.default_rng(seed)
    amp = (0.01 / 2.0 ** (np.arange(6 * m) // 6)).astype(np.float32)[:, None]
    for l in (0, 4):
        v = params[l]["v"]
        v[-6 * m:] += amp * rng.standard_normal(v[-6 * m:].shape).astype(np.float32)
    return params


@pytest.fixture(scope="module", params=MULTIRES)
def sdf_setup(request):
    m = request.param
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                    init_sdf(jax.random.PRNGKey(3), JSDFConfig(multires=m)))
    params = _live_pe(params, m)
    rng = np.random.default_rng(m)
    pts = rng.uniform(-0.7, 0.7, (N_PTS, 3)).astype(np.float32)
    cot = (rng.standard_normal((N_PTS, 256)) * 0.1).astype(np.float32)
    return m, params, pts, cot


def _pe_rows(pts, scale, m, pe_w):
    """[4n, pe_w]: PE(m) of the scaled points, then its d/dx, d/dy, d/dz
    rows, as csrc/sdf_net.cuh::pe_tile builds them."""
    n = pts.shape[0]
    out = torch.zeros(4, n, pe_w)
    xs = pts * scale
    out[0, :, :3] = xs
    for j in range(3):
        out[1 + j, :, j] = scale
    for i in range(m):
        f = 2.0 ** i
        for k in range(3):
            x = xs[:, k] * f
            out[0, :, 3 + 6 * i + k] = torch.sin(x)
            out[0, :, 6 + 6 * i + k] = torch.cos(x)
            out[1 + k, :, 3 + 6 * i + k] = scale * f * torch.cos(x)
            out[1 + k, :, 6 + 6 * i + k] = -scale * f * torch.sin(x)
    return out.reshape(4 * n, pe_w)


def emulate_b1_forward(W, bias, beta, scale, pts, m):
    """csrc/sdf_grad.cu's forward on its packed weights at multires m, in
    plain torch with its rounding points: bf16 PE and activations, f32 sums,
    the tangent rule on the stacked [primal, d/dx, d/dy, d/dz] rows, layer
    3's mask. Returns (sdf [n, 1], feats [n, 256], grad [n, 3])."""
    lay = G.layout(m)
    n = pts.shape[0]
    sizes = [r * c for r, c in lay.pack_shapes]
    w0, w1, w2, w3, w4a, w4b, w5, w6, w7, w8 = (
        t.view(r, c).float() for t, (r, c) in zip(torch.split(W, sizes), lay.pack_shapes))
    primal = (torch.arange(4 * n) < n)[:, None].float()
    mask = (torch.arange(G.HID) < lay.skip_w).float()
    pe = _bf(_pe_rows(pts, scale, m, lay.pe_w))
    h = None
    for l, wl in enumerate([w0, w1, w2, w3, w4a, w5, w6, w7]):
        z = (pe if l == 0 else h) @ wl + (pe @ w4b if l == 4 else 0.0)
        z = z + bias[l, :G.HID] * primal
        zp = z[:n]
        act = torch.cat([torch.nn.functional.softplus(beta * zp) / beta,
                         torch.sigmoid(beta * zp).repeat(3, 1) * z[n:]])
        h = _bf(act * mask if l == 3 else act)
    out = h[:n] @ w8 + bias[8]
    grad = torch.stack([(h[(k + 1) * n:(k + 2) * n] @ w8[:, :1])[:, 0] for k in range(3)], -1)
    return out[:, :1], out[:, 1:257], grad


def _port_loss(p, x, c, m):
    sdf, feats, grad = G.sdf_with_grad(p, x, SDFConfig(multires=m))
    eik = ((torch.linalg.norm(grad, dim=-1) - 1.0) ** 2).mean()
    return (sdf ** 2).mean() + 0.1 * eik + (feats * c).mean()


def _reference_b1(params, pts, m):
    """What the port's B1 is held to at multires m: nero_tpu's
    `sdf_with_grad_fused` in interpret mode from multires 6 on; below it
    nero_tpu's XLA `sdf_with_grad` (f32), since its kernel masks layer 3 at a
    fixed 217 columns (sdf_grad_kernel.py:199,268), the width at multires 6,
    where the layer is 256 - (3 + 6 multires) wide: below 6 it drops live
    columns (test_nero_tpu_kernel_masks_layer_3_at_217). Returns the function
    of (params, points) and the bars' name."""
    if m >= 6:
        return (lambda q, x: sdf_with_grad_fused(q, x, JSDFConfig(multires=m), interpret=True),
                "pallas")
    return (lambda q, x: jax_sdf_with_grad(q, x, JSDFConfig(multires=m))), "xla"


def test_sdf_with_grad_twins_against_nero_tpu(sdf_setup):
    """B1's plain twin (the wrapper on the CPU) and the emulation of its
    kernel on the port's packed weights against nero_tpu (`_reference_b1`),
    at tests/test_sdf_grad_kernel.py's bars: sdf 5e-3 + 1e-2 rel, grad
    2e-2 + 5e-2 rel, feats' mean 5e-3; every {v, g, b} gradient of the loss
    of tests/test_torch_sdf_grad.py within 2e-2 of its leaf's max, the loss
    within 1e-2."""
    m, params, pts, cot = sdf_setup
    fn, _ = _reference_b1(params, pts, m)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    ref = [np.asarray(a) for a in fn(pj, jnp.asarray(pts))]
    p = from_numpy_tree(params)
    x, c = torch.from_numpy(pts), torch.from_numpy(cot)
    layers = resolve_weight_norm(p)
    with torch.no_grad():
        plain = G.sdf_with_grad(p, x, SDFConfig(multires=m))
        W, bias = G.pack_weights([l["w"] for l in layers], [l["b"] for l in layers])
        emu = emulate_b1_forward(W, bias, 100.0, 1.0, x, m)
    for got in (plain, emu):
        np.testing.assert_allclose(got[0].numpy(), ref[0], atol=5e-3, rtol=1e-2)
        np.testing.assert_allclose(got[2].numpy(), ref[2], atol=2e-2, rtol=5e-2)
        assert np.abs(got[1].numpy() - ref[1]).mean() < 5e-3

    def jax_loss(q):
        sdf, feats, grad = fn(q, jnp.asarray(pts))
        eik = jnp.mean((jnp.linalg.norm(grad, axis=-1) - 1.0) ** 2)
        return jnp.mean(sdf ** 2) + 0.1 * eik + jnp.mean(feats * jnp.asarray(cot))

    loss_j, g_j = jax.value_and_grad(jax_loss)(pj)
    loss_t = _port_loss(p, x, c, m)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-2)
    for k, a in tree_items(jax.tree_util.tree_map(np.asarray, g_j)):
        got = dict(tree_items(p))[k].grad.numpy()
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(got / scale, a / scale, atol=2e-2, err_msg=f"m={m} {k}")


def test_nero_tpu_kernel_masks_layer_3_at_217():
    """A reference quirk the port does not copy: at multires 4 layer 3 is
    229 wide, and nero_tpu's kernel zeroes its columns 217-228 (the mask of
    multires 6), so its sdf leaves its own XLA path by more than the
    kernel's bar, where the port's kernel layout (layer 3 masked at
    256 - NPE, csrc/sdf_net.cuh MASK_W) and its plain twin stay on it."""
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                    init_sdf(jax.random.PRNGKey(3), JSDFConfig(multires=4)))
    pts = np.random.default_rng(0).uniform(-0.7, 0.7, (N_PTS, 3)).astype(np.float32)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    xla = np.asarray(jax_sdf_with_grad(pj, jnp.asarray(pts), JSDFConfig(multires=4))[0])
    pallas = np.asarray(sdf_with_grad_fused(pj, jnp.asarray(pts), JSDFConfig(multires=4),
                                            interpret=True)[0])
    assert np.abs(pallas - xla).max() > 5e-3 + 1e-2 * np.abs(xla).max()
    assert G.layout(4).skip_w == 229
    p = from_numpy_tree(params, requires_grad=False)
    layers = resolve_weight_norm(p)
    W, bias = G.pack_weights([l["w"] for l in layers], [l["b"] for l in layers])
    emu = emulate_b1_forward(W, bias, 100.0, 1.0, torch.from_numpy(pts), 4)[0]
    np.testing.assert_allclose(emu.numpy(), xla, atol=5e-3, rtol=1e-2)


@pytest.mark.parametrize("m", MULTIRES + (20,))
def test_sdf_packing_against_pallas(m):
    """B1's packed layout at multires m holds nero_tpu's packed blocks
    (`pack_sdf_grad_params`, padded to PE_PAD 128 and 384 outputs) in its
    own padding (PE to a multiple of 16, 272 outputs), to the bf16 rounding
    of the port's buffer, zeros elsewhere; B6 packs the same hidden layers
    and of the last layer the sdf column; the gradients unpack to every
    layer's shape."""
    params = _live_pe(jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32), init_sdf(jax.random.PRNGKey(3),
                                                    JSDFConfig(multires=m))), m)
    jcfg = JSDFConfig(multires=m)
    lay = G.layout(m)
    assert lay.n_pe == 3 + 6 * m <= PE_PAD and lay.pe_w % 16 == 0
    ref = {k: np.asarray(v) for k, v in pack_sdf_grad_params(
        jax.tree_util.tree_map(jnp.asarray, params), jcfg).items()}
    layers = resolve_weight_norm(from_numpy_tree(params, requires_grad=False))
    ws, bs = [l["w"] for l in layers], [l["b"] for l in layers]
    W, bias = G.pack_weights(ws, bs)
    sizes = [r * c for r, c in lay.pack_shapes]
    parts = dict(zip(("w0", "w1", "w2", "w3", "w4a", "w4b", "w5", "w6", "w7", "w8"),
                     (t.view(r, c).float().numpy() for t, (r, c) in
                      zip(torch.split(W, sizes), lay.pack_shapes))))
    bf = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16).float().numpy()
    # weight norm resolves in another order in the two packages: one bf16
    # rounding step (at most 2^-7 relative) apart where the f32 values
    # straddle a rounding boundary
    for k, got in parts.items():
        rows, cols = got.shape
        want = ref[k][:rows, :cols]
        np.testing.assert_allclose(got, bf(want), rtol=2.0 ** -7, atol=1e-6,
                                   err_msg=f"m={m} {k}")
        assert not np.abs(ref[k][rows:]).any() and not np.abs(ref[k][:, cols:257]).any(), k
    assert not parts["w0"][lay.n_pe:].any() and not parts["w3"][:, lay.skip_w:].any()
    np.testing.assert_allclose(bias.numpy(), ref["b"][:9, :G.OUT_W], rtol=1e-6, atol=1e-7)
    dws, dbs = G.unpack_grads(W.float(), bias, m)
    assert [tuple(d.shape) for d in dws] == [tuple(w.shape) for w in ws]
    assert [tuple(d.shape) for d in dbs] == [tuple(b.shape) for b in bs]
    # B6: the hidden layers the same bits, of w8 the sdf column and its bias
    W6, b6 = S.pack_params(from_numpy_tree(params, requires_grad=False), SDFConfig(multires=m))
    assert W6.numel() == W.numel()
    h8 = sum(sizes[:9])
    assert torch.equal(W6[:h8], W[:h8])
    w8_6 = W6[h8:].view(G.HID, G.OUT_W)
    assert torch.equal(w8_6[:, 0], W[h8:].view(G.HID, G.OUT_W)[:, 0]) and not w8_6[:, 1:].any()
    assert torch.equal(b6[:8], bias[:8]) and b6[8, 0] == bias[8, 0] and not b6[8, 1:].any()
    # nero_tpu's value-only packing: the same weights at its padding
    ref6 = pack_sdf_params(jax.tree_util.tree_map(jnp.asarray, params), jcfg)
    np.testing.assert_allclose(parts["w0"][:lay.n_pe], bf(np.asarray(ref6["w0"])[:lay.n_pe]),
                               rtol=2.0 ** -7, atol=1e-6)
    np.testing.assert_allclose(w8_6[:, 0].float().numpy(), bf(np.asarray(ref6["w8"])[:, 0]),
                               rtol=2.0 ** -7, atol=1e-6)


def test_sdf_fwd_twin_against_pallas(sdf_setup):
    """B6's plain twin against nero_tpu's `sdf_fwd_fused` in interpret mode
    at tests/test_pallas_kernels.py's bar (atol 2e-2: bf16 operands), and the
    emulated B1 forward's sdf against it too (B6's bits are B1's)."""
    m, params, pts, _ = sdf_setup
    jcfg = JSDFConfig(multires=m)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    ref = np.asarray(sdf_fwd_fused(pack_sdf_params(pj, jcfg), jnp.asarray(pts), jcfg,
                                   interpret=True))
    p = from_numpy_tree(params, requires_grad=False)
    got = S.sdf_fwd(p, torch.from_numpy(pts), SDFConfig(multires=m))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-2)
    W, bias = S.pack_params(p, SDFConfig(multires=m))
    emu = emulate_b1_forward(W, bias, 100.0, 1.0, torch.from_numpy(pts), m)[0]
    np.testing.assert_allclose(emu.numpy(), ref, atol=2e-2)


# ---------------------------------------------------------------------------
# B5 at IDE degrees 1-4
# ---------------------------------------------------------------------------

LIGHT_CASES = [(d, mode) for d in (1, 2, 3, 4) for mode in ("both", "outer")]


@pytest.mark.parametrize("ide_deg,mode", LIGHT_CASES)
def test_lights_twin_against_pallas(ide_deg, mode):
    """The light kernel's plain twin against nero_tpu's `lights_fused_raw`
    in interpret mode (mode `both` with the `direction` outer light, `outer`
    with `sphere_direction`): values after exp to 3e-3 (tests/
    test_light_kernel.py's bar); gradients below degree 5 (ROADMAP's
    tolerances): every head parameter within cosine 0.99 and (mode `both`)
    the direction cotangent within 0.98 of the Pallas kernel's (with
    `sphere_direction` nero_tpu's kernel normalises the sphere hit and the
    port, as the unfused path, does not: the directions' gradients differ by
    design, ROADMAP's reference quirks); the packed buffers unpack to every
    head's shape at the degree's padding."""
    version = "direction" if mode == "both" else "sphere_direction"
    base = dict(human_lights=False, outer_light_version=version, bf16_hidden=False,
                ide_deg=ide_deg)
    cfg_j, cfg_t = JM.MCShadingConfig(**base), TM.MCShadingConfig(**base)
    params = jax.tree_util.tree_map(np.asarray, JM.init_mc_shading(jax.random.PRNGKey(ide_deg),
                                                                   cfg_j))
    rng = np.random.default_rng(ide_deg)
    n = 40
    pts = rng.uniform(-0.62, 0.62, (n, 3)).astype(np.float32)
    dirs = rng.standard_normal((n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    inters = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    normals = rng.standard_normal((n, 3)).astype(np.float32)
    cots = rng.standard_normal((2, n, 3)).astype(np.float32)
    heads = ("inner_light", "outer_light") if mode == "both" else ("outer_light",)

    def jax_loss(q, d):
        i, o = lights_fused_raw(q, cfg_j, jnp.asarray(pts), d, jnp.asarray(inters),
                                jnp.asarray(normals), mode=mode, interpret=True)
        return jnp.sum(exp_jax(i, 5.0) * cots[0]) + jnp.sum(exp_jax(o, 5.0) * cots[1]), (i, o)

    pj = jax.tree_util.tree_map(jnp.asarray, params)
    (_, (i_j, o_j)), (gp_j, gd_j) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        pj, jnp.asarray(dirs))
    p = from_numpy_tree(params)
    d_t = torch.from_numpy(dirs).requires_grad_(True)
    i_t, o_t = L.lights_raw(p, cfg_t, torch.from_numpy(pts), d_t, torch.from_numpy(inters),
                            torch.from_numpy(normals), mode)
    for a, b in ((i_t, i_j), (o_t, o_j)):
        np.testing.assert_allclose(exp_activation(a, 5.0).detach().numpy(),
                                   np.asarray(exp_jax(b, 5.0)), atol=3e-3, rtol=0)
    loss = (exp_activation(i_t, 5.0) * torch.from_numpy(cots[0])).sum() + \
        (exp_activation(o_t, 5.0) * torch.from_numpy(cots[1])).sum()
    leaves = [v for k, v in tree_items(p) if k.split("|")[0] in heads]
    g_t = torch.autograd.grad(loss, leaves + [d_t])
    g_j = dict(tree_items(jax.tree_util.tree_map(np.asarray, gp_j)))
    keys = [k for k, _ in tree_items(p) if k.split("|")[0] in heads]
    cos = lambda a, b: float(a.ravel() @ b.ravel() / (np.linalg.norm(a) * np.linalg.norm(b)
                                                      + 1e-12))
    for k, g in zip(keys, g_t):
        if np.linalg.norm(g_j[k]) > 1e-9:
            assert cos(g.numpy(), g_j[k]) > 0.99, (ide_deg, mode, k)
    if version == "direction":
        assert cos(g_t[-1].numpy(), np.asarray(gd_j)) > 0.98
    # the packed buffers at the degree's padding, and back
    geo, sphere, both, ws, bs = L.kernel_inputs(p, cfg_t, *(torch.from_numpy(a) for a in
                                                             (pts, dirs, inters, normals)), mode)
    W, B = L.pack_buffers(ws, bs, sphere, both, ide_deg)
    assert W.numel() == L.weight_elems(sphere, both, ide_deg)
    dws, dbs = L.unpack_grads(W.float(), B, [tuple(w.shape) for w in ws], sphere, both, ide_deg)
    for w, d in zip(ws, dws):
        torch.testing.assert_close(d, _bf(w.detach()), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the gates: nero_tpu's rules, and the port's light_pos_freq limit
# ---------------------------------------------------------------------------


def test_sdf_gates_agree_with_nero_tpu():
    """multires 0-21 with the other SDF keys at their defaults and at each
    topology nero_tpu refuses: B1 where nero_tpu's ShapeConfig resolves
    `fused` (its _fused_sdf_supported and d_out 257) and its kernel packs
    the PE (3 + 6 multires <= PE_PAD), B6 where _fused_sdf_supported and
    the PE packs (nero_tpu/render/shape.py:177-180 drops use_fused_sdf
    otherwise); the port resolves the same on CUDA, without a warning
    where it takes the kernel."""
    overs = [{}, {"sdf_n_layers": 6}, {"sdf_d_out": 129}]
    with force_interpret():
        for over in overs:
            for m in range(0, 22):
                keys = dict(over, sdf_freq=m, sdf_grad_mode="fused")
                jcfg = JR.ShapeConfig(**{k: v for k, v in keys.items()})
                packs = 3 + 6 * m <= PE_PAD
                nero_b6 = JR._fused_sdf_supported(jcfg) and packs
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    nero_b1 = jcfg.grad_mode == "fused" and packs
                scfg = TR.ShapeConfig(**keys)
                assert G.supported(scfg.sdf_cfg) == nero_b1, keys
                assert S.supported(scfg.sdf_cfg) == nero_b6, keys
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    mode = scfg.grad_mode("cuda")
                    fused = TR.shape_config_from_dict(dict(keys, use_fused_sdf=True)).use_fused_sdf
                assert (mode == "fused") == nero_b1 and fused == nero_b6, keys
                assert bool(caught) == (not nero_b1 or not nero_b6), (keys, caught)


def test_shader_and_light_gates_agree_with_nero_tpu():
    """ide_deg 0-6 x feats_dim {128, 256} x light_pos_freq {0, 1, 4, 8, 10,
    16, 17, 24}: the shader kernel takes a configuration exactly where
    nero_tpu's fused_shader_supported does and light_pos_freq <= MAX_LIGHT_PE
    (128, the port's stated limit, which nero_tpu has not); the light kernel (with
    fused_lights) exactly where nero_tpu's resolver takes its kernel
    (outer_compact_frac 0 and ide_deg <= 5), for outer_compact_frac 0 and
    0.75. Degree 0 and 6 make no IDE in either package: the rules are held
    all the same."""
    for deg in range(0, 7):
        for feats in (128, 256):
            for lpf in (0, 1, 4, 8, 10, 16, 17, 24):
                nero = fused_shader_supported(JShCfg(ide_deg=deg, feats_dim=feats,
                                                     light_pos_freq=lpf))
                cfg = AppShadingConfig(ide_deg=deg, feats_dim=feats, light_pos_freq=lpf)
                assert Sh.supported(cfg) == (nero and lpf <= Sh.MAX_LIGHT_PE), (deg, feats, lpf)
        for frac in (0.0, 0.75):
            jcfg = JM.MCShadingConfig(fused_lights=True, ide_deg=deg, outer_compact_frac=frac)
            with force_interpret(), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                nero = JM._fused_lights_active(jcfg)
            tcfg = TM.MCShadingConfig(fused_lights=True, ide_deg=deg, outer_compact_frac=frac)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                assert TM.fused_lights_active(tcfg) == nero, (deg, frac)
            assert L.supported(tcfg) == (deg <= 5)


# ---------------------------------------------------------------------------
# the FLOP tallies at the new widths
# ---------------------------------------------------------------------------


class _FakeLib:
    """A kernel library that launches nothing: every C entry returns 0, and
    the size queries answer as the given function does."""

    def __init__(self, sizes):
        self.sizes = sizes

    def __getattr__(self, name):
        return lambda *args: self.sizes(name, args)


def _fake_stream(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("Stream", (), {"cuda_stream": 0})())


def test_flop_tallies_at_new_widths(monkeypatch):
    """Each wrapper counts a launch at a width other than the shipped one
    under that width's counter (`_m<multires>`, `_d<deg>p<pe>`, `_d<deg>`)
    and adds launches x flops(...) at that width to its tally; flops follow
    the products' widths."""
    _fake_stream(monkeypatch)
    for mod in (G, S, Sh, L):
        monkeypatch.setattr(mod, "launches", dict(mod.launches))
        monkeypatch.setattr(mod, "flop_tally", dict(mod.flop_tally))
    n = 96
    sized = lambda name, args: 64 if "elems" in name else 0  # buffer sizes; rc 0
    monkeypatch.setattr(G, "_lib", lambda m=6: _FakeLib(sized))
    pts, W, b = torch.zeros(n, 3), torch.zeros(10), torch.zeros(9, G.OUT_W)
    for _ in range(3):
        G._fwd(pts, W, b, 100.0, 1.0, 8)
    G._bwd(pts, W, b, 100.0, 1.0, torch.zeros(n), torch.zeros(n, 3), torch.zeros(n, 256), 8)
    assert G.launches["sdf_grad_fwd_m8"] == 3 and G.launches["sdf_grad_bwd_m8"] == 1
    assert G.flop_tally["sdf_grad_fwd_m8"] == 3 * G.flops(n, multires=8)
    assert G.flop_tally["sdf_grad_bwd_m8"] == G.flops(n, backward=True, multires=8)
    assert G.launches["sdf_grad_fwd"] == 0
    # the forward's products do not change with multires (the PE's rows in
    # layers 0 and 4 trade with layer 3's columns: 256 in all); the backward
    # takes no cotangent into the PE, so it shrinks as the PE grows
    assert G.flops(n, multires=8) == G.flops(n) == G.flops(n, multires=4)
    assert G.flops(n, True, 8) < G.flops(n, True) < G.flops(n, True, 4)
    # B6 through the packed path at multires 8
    monkeypatch.setattr(S, "_lib", lambda m=6: _FakeLib(sized))
    S.sdf_fwd_packed((W, b), torch.zeros(n, 3), SDFConfig(multires=8))
    assert S.launches["sdf_fwd_m8"] == 1 and S.flop_tally["sdf_fwd_m8"] == S.flops(n, 8)
    # B2 at (4, 10), each variant
    for sphere, human in ((0, 0), (1, 0), (0, 1), (1, 1)):
        cfg = AppShadingConfig(sphere_direction=bool(sphere), human_light=bool(human),
                               ide_deg=4, light_pos_freq=10)
        pads = Sh.head_pad(cfg)
        welems = Sh.weight_elems([pads[h] for h in Sh.head_order(cfg)])
        monkeypatch.setattr(Sh, "_lib", lambda enc=(5, 8): _FakeLib(
            lambda name, args: welems if name == "shader_weight_elems" else 0
            if "elems" not in name else 64))
        geo, feats = torch.zeros(n, Sh.geo_width(cfg)), torch.zeros(n, 256)
        Wsh = torch.zeros(welems)
        Sh._fwd(geo, feats, Wsh, torch.zeros(7, 4, 256), sphere, human, (4, 10))
        Sh._bwd(geo, feats, Wsh, torch.zeros(7, 4, 256), sphere, human, torch.zeros(n, 24),
                (4, 10))
        sfx = Sh.variant(cfg)
        assert sfx.endswith("_d4p10")
        assert Sh.launches["shader_fwd" + sfx] == 1 and Sh.launches["shader_bwd" + sfx] == 1
        assert Sh.flop_tally["shader_fwd" + sfx] == Sh.flops(n, cfg)
        assert Sh.flop_tally["shader_bwd" + sfx] == Sh.flops(n, cfg, backward=True)
        assert Sh.flops(n, cfg) < Sh.flops(n, Sh.variant_cfg(sphere, human))
    # B5 at degree 4, both modes
    monkeypatch.setattr(L, "_lib", lambda d=5: _FakeLib(sized))
    for both, name in ((True, ""), (False, "_outer")):
        cfg = L.variant_cfg(not both, 4)
        mode = "both" if both else "outer"
        L._fwd(torch.zeros(n, 12), torch.zeros(10), torch.zeros(2, 4, 256), not both, both, 4)
        L._bwd(torch.zeros(n, 12), torch.zeros(10), torch.zeros(2, 4, 256), not both, both,
               torch.zeros(n, 6), 4)
        assert L.launches[f"lights_fwd{name}_d4"] == 1 and L.launches[f"lights_bwd{name}_d4"] == 1
        assert L.flop_tally[f"lights_fwd{name}_d4"] == L.flops(n, cfg, mode)
        assert L.flop_tally[f"lights_bwd{name}_d4"] == L.flops(n, cfg, mode, backward=True)
        assert L.flops(n, cfg, mode) < L.flops(n, L.variant_cfg(not both), mode)


# ---------------------------------------------------------------------------
# shared memory and layouts at every width the kernels take
# ---------------------------------------------------------------------------


def test_sdf_layouts_and_smem_at_every_multires():
    """csrc/sdf_net.cuh at NERO_SDF_MULTIRES 1-20: PEW, NPE and the layer-3
    mask as ops/sdf_grad.py::layout states them, 128-row slabs up to PEW
    64 and 64 from there, and B1's (and B6's 128-point) tile of activations,
    PE and ring within a block's 232,448 bytes; B1's output staging and
    cotangent tile over the activations and the PE."""
    names = ("HID", "NPE", "PEW", "MASK_W", "OUTW", "SLAB_K", "LDH", "LDP", "STAGE_ELEMS",
             "STAGES", "PE_SLABS", "H_SLABS", "W8_KSLABS")
    for m in range(1, 21):
        c = source_constants(("sdf_net.cuh",), names, {"NERO_SDF_MULTIRES": m})
        lay = G.layout(m)
        assert (c["NPE"], c["PEW"], c["MASK_W"]) == (lay.n_pe, lay.pe_w, lay.skip_w), m
        assert c["SLAB_K"] == (128 if lay.pe_w <= 64 else 64)
        assert c["PE_SLABS"] * c["SLAB_K"] >= c["PEW"] and c["H_SLABS"] * c["SLAB_K"] == 256
        smem = (128 * c["LDH"] + 128 * c["LDP"] + c["STAGES"] * c["STAGE_ELEMS"]) * 2
        assert smem <= SMEM_MAX, (m, smem)
        g = source_constants(("sdf_grad.cu", "sdf_net.cuh"), ("LDG", "LDO", "ROWS", "P"),
                             {"NERO_SDF_MULTIRES": m})
        assert g["ROWS"] * g["LDG"] <= g["ROWS"] * (c["LDH"] + c["LDP"])
        assert g["P"] * g["LDO"] * 4 + g["P"] * 12 <= g["ROWS"] * c["LDH"] * 2
        # the packed weights: what the ring streams is what ops/sdf_grad.py packs
        total = sum(r * cc for r, cc in lay.pack_shapes)
        assert total == 2 * c["PEW"] * 256 + 7 * 256 * 256 + 256 * c["OUTW"]


def _shader_slabs(cfg, k):
    heads = Sh.head_order(cfg)
    pads = Sh.head_pad(cfg)
    evals = ["metallic", "roughness", "albedo", "outer_light", "outer_light", "inner_light",
             "inner_weight"] + (["human_light"] if cfg.human_light else [])
    fwd = sum(-(-pads[h] // k) + 3 * (256 // k) for h in evals)
    sweep = sum(1 + (2 if h == "inner_weight" else 3) * (256 // k) for h in evals)
    return fwd, fwd + sweep, heads


def test_shader_smem_at_every_encoding():
    """csrc/shader.cu at every (ide_deg 1-5, light_pos_freq 0-16) in its four
    variants: the head widths ops/shader.py pads to, the light heads' inputs
    within one 256-wide tile, the f32 input cotangent of the widest light
    head within the tile region, 64-row slabs exactly where that region
    outgrows the activation and points tiles, and both kernels' shared
    memory (tiles, ring, row state, IDE table, slab table) within a block's
    232,448 bytes."""
    names = ("PB", "LDA", "LDP", "SLAB_K", "LDB", "LDT", "STAGES", "RSB", "TAB", "TILE_ELEMS",
             "DX_MAX", "DI_OUTER", "DI_OUTER_SPH", "DI_INNER", "DI_OCC", "NIDE")
    for deg in range(1, 6):
        for lpf in range(0, 17):
            c = source_constants(("encode.cuh", "shader.cu"), names,
                                 {"NERO_IDE_DEG": deg, "NERO_LIGHT_PE": lpf})
            assert c["NIDE"] == ide_dim(deg)
            stage = max(c["SLAB_K"] * c["LDB"], 256 * c["LDT"])
            assert c["TILE_ELEMS"] * 2 >= c["PB"] * c["DX_MAX"] * 4
            assert (c["SLAB_K"] == 64) == (c["PB"] * c["DX_MAX"] * 2 > c["PB"] * (c["LDA"] + c["LDP"]))
            for sphere in (False, True):
                for human in (False, True):
                    cfg = AppShadingConfig(sphere_direction=sphere, human_light=human,
                                           ide_deg=deg, light_pos_freq=lpf)
                    pads = Sh.head_pad(cfg)
                    assert pads["outer_light"] == (c["DI_OUTER_SPH"] if sphere else c["DI_OUTER"])
                    assert (pads["inner_light"], pads["inner_weight"]) == (c["DI_INNER"],
                                                                           c["DI_OCC"])
                    assert max(pads["outer_light"], pads["inner_light"]) <= c["DX_MAX"] <= 256
                    _, n_slabs, _ = _shader_slabs(cfg, c["SLAB_K"])
                    smem = ((c["TILE_ELEMS"] + c["STAGES"] * stage) * 2 + c["PB"] * c["RSB"] * 4
                            + c["TAB"] * 4 + n_slabs * 12)
                    assert smem <= SMEM_MAX, (deg, lpf, sphere, human, smem)


def test_lights_smem_at_every_degree():
    """csrc/lights.cu at NERO_IDE_DEG 1-5: the padded head widths of
    ops/lights.py::di_pad, the inner head's dX over its IDE columns from
    n8-tile 48 (a multiple of 16 wide), and the sweep's shared memory within
    a block's 232,448 bytes in every layout."""
    names = ("DI_INNER", "DI_OUTER", "DI_OUTER_SPH", "DX0_INNER", "PB", "LDA", "RSB", "TAB",
             "SLAB_K", "LDB", "LDT", "STAGES", "LAYER_W")
    for deg in range(1, 6):
        c = source_constants(("encode.cuh", "engine.cuh", "lights.cu"), names,
                             {"NERO_IDE_DEG": deg})
        pad = L.di_pad(deg)
        assert (c["DI_INNER"], c["DI_OUTER"], c["DI_OUTER_SPH"]) == (
            pad["inner_light"], pad["outer_light"], pad["outer_light_sphere"])
        dxw = c["DI_INNER"] - c["DX0_INNER"]
        assert c["DX0_INNER"] == 48 and dxw % 16 == 0 and dxw >= pad["inner_light"] - 51
        stage = max(c["SLAB_K"] * c["LDB"], c["LAYER_W"] * c["LDT"])
        for sphere in (False, True):
            dx_max = max(dxw, c["DI_OUTER_SPH"] if sphere else c["DI_OUTER"])
            tile = max(c["PB"] * c["LDA"] * 2, c["PB"] * dx_max * 4)
            di = [c["DI_INNER"], c["DI_OUTER_SPH"] if sphere else c["DI_OUTER"]]
            n_slabs = sum(-(-d // c["SLAB_K"]) + 5 * (256 // c["SLAB_K"]) + 1 for d in di)
            smem = (tile + c["STAGES"] * stage * 2 + c["PB"] * c["RSB"] * 4 + c["TAB"] * 4
                    + n_slabs * 12)
            assert smem <= SMEM_MAX, (deg, sphere, smem)


def test_kernel_variants_take_the_encodings(monkeypatch):
    """`kernel_variants --encodings` builds every library of the call with
    the width's -D macros and shapes the inputs to match: multires for the
    SDF kernels, (ide_deg, light_pos_freq) for the shader, ide_deg for the
    light kernel; a kernel without encodings refuses it."""
    from nero_tpu_torch import kernel_variants as KV

    monkeypatch.setattr(KV, "DEFINES", ())
    assert KV._encodings("sdf_grad", None) is None and KV.DEFINES == ()
    assert KV._encodings("sdf_fwd", "8") == 8
    assert KV.DEFINES == (("NERO_SDF_MULTIRES", 8),)
    assert KV._encodings("shader", "4,10") == (4, 10)
    assert KV.DEFINES == (("NERO_IDE_DEG", 4), ("NERO_LIGHT_PE", 10))
    assert KV._encodings("lights", "3") == 3 and KV.DEFINES == (("NERO_IDE_DEG", 3),)
    with pytest.raises(SystemExit):
        KV._encodings("sphere_march", "7")
    params = KV.sdf_params(SDFConfig(multires=8), "cpu")
    assert params[0]["v"].shape[0] == 51 and params[0]["v"][3:].abs().max() > 0
    assert KV.sdf_params(SDFConfig(), "cpu")[0]["v"][3:].abs().max() == 0
