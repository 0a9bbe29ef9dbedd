"""The whole-shader kernel's backward (csrc/shader.cu: recompute and reverse
sweep, parameter pass, reduction) as far as the CPU can hold it: its
rounding points emulated in plain torch (`emulate_shader_bwd`) against the
port's f32 plain gradients and nero_tpu's XLA gradients, in all four
variants, at chip_smoke.py's bars: every gradient leaf within cosine 0.99 of
the f32 one, 0.98 with the human light (tests/test_shader_kernel.py's
test_human_light_grad_parity). Also the zero-row case of the wrapper, a
mirror of the backward's buffer sizes against the constants of the source,
and the patches of `nero_tpu_torch/kernel_variants.py`. The kernel itself is
held against its plain version and this emulation on the card by the
`gpu`-marked test and by chip_smoke.py."""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nero_tpu.fields.app_shading import AppShadingConfig as JCfg, app_shading_apply as jax_apply
from nero_tpu.ops.fg_lut import get_fg_lut as jax_fg_lut
from nero_tpu_torch import kernel_variants
from nero_tpu_torch.core.convert import from_numpy_tree, tree_items
from nero_tpu_torch.fields.app_shading import AppShadingConfig, shade_from_raw
from nero_tpu_torch.ops import cuda_build, shader
from nero_tpu_torch.ops.fg_lut import get_fg_lut
from nero_tpu_torch.ops.mlp import resolve_weight_norm
from torch_shader_common import R, S, VARIANTS, _kernel_head, _setup

torch.set_num_threads(1)

@pytest.fixture(scope="module", params=list(VARIANTS))
def setup(request):
    return (request.param,) + _setup(request.param)


# ---------------------------------------------------------------------------
# the backward's rounding points
# ---------------------------------------------------------------------------


def emulate_shader_bwd(W, B, geo, feats, gout, sphere: bool, human: bool):
    """The backward of csrc/shader.cu in plain torch with its rounding points:
    bf16 X, H and GZ, f32 sums, the encodings' backward in f32, the outer
    head's two evaluations summed into one dW (autograd adds them). geo [n, 9
    or 21], feats [n, 256], gout [n, 24] -> (dgeo [n, 9], dfeats [n, 256], dW
    packed f32, dB [heads, 4, 256]), the kernel's outputs."""
    cfg = AppShadingConfig(sphere_direction=sphere, human_light=human)
    heads = shader.head_order(cfg)
    pads = [shader.head_pad(cfg)[h] for h in heads]
    dims = [shader.head_dims(cfg)[h] for h in heads]
    dws, dbs = shader.unpack_grads(W.float(), B, pads, dims)
    layers = {h: [{"w": dws[4 * k + l].clone().requires_grad_(True),
                   "b": dbs[4 * k + l].clone().requires_grad_(True)} for l in range(4)]
              for k, h in enumerate(heads)}
    n = geo.shape[0]
    ins = [geo[:, 3 * i:3 * i + 3].clone().requires_grad_(True) for i in range(3)]
    fe = feats.clone().requires_grad_(True)
    poses = None
    if human:
        poses = torch.cat([geo[:, 9:18].reshape(n, 3, 3), geo[:, 18:21, None]], -1)
    with torch.enable_grad():
        raw = shader.shader_raw_plain(layers, cfg, *ins, fe, poses, head=_kernel_head)
        leaves = [l[k] for h in heads for l in layers[h] for k in ("w", "b")]
        g = torch.autograd.grad(raw, leaves + ins + [fe], gout)
    parts, dB = [], torch.zeros_like(B)
    for k, di in enumerate(pads):
        for l, (rows, cols) in enumerate(((di, 256), (256, 256), (256, 256), (256, 16))):
            gw, gb = g[8 * k + 2 * l], g[8 * k + 2 * l + 1]
            parts.append(F.pad(gw, (0, cols - gw.shape[1], 0, rows - gw.shape[0])).reshape(-1))
            dB[k, l, :gb.shape[0]] = gb
    return torch.cat(g[-4:-1], -1), g[-1], torch.cat(parts), dB


def _loss(c, o, cots):
    return (c * torch.from_numpy(cots[0])).sum() + (o["occ_prob"] * torch.from_numpy(cots[1])).sum()


def _reference_and_emulated(kw, params_j, inputs, cots):
    """(f32 plain gradients, emulated kernel gradients) over the param leaves
    and pts, normals, view, feats."""
    cfg = AppShadingConfig(**kw)
    p = from_numpy_tree(params_j)
    t = {k: torch.from_numpy(v).requires_grad_(k != "hp") for k, v in inputs.items()}
    lut = torch.from_numpy(get_fg_lut())
    hp = t["hp"] if cfg.human_light else None
    leaves = [v for _, v in tree_items(p)]
    xs = [t[k] for k in ("pts", "normals", "view", "feats")]
    raw = shader.shader_raw_plain(p, cfg, *xs, hp)
    want = torch.autograd.grad(_loss(*shade_from_raw(raw, cfg, lut), cots), leaves + xs)
    # the cotangent of the packed raw outputs, then the kernel's backward
    raw_d = raw.detach().requires_grad_(True)
    gout = torch.autograd.grad(_loss(*shade_from_raw(raw_d, cfg, lut), cots), raw_d)[0]
    geo, feats2d, spec, ws, bs = shader.kernel_inputs(p, cfg, *xs, hp)
    with torch.no_grad():
        W, B = shader.pack_weights(ws, bs, spec[2])
        dgeo, dfeats, dW, dB = emulate_shader_bwd(W, B, geo.detach(), feats2d.detach(),
                                                  gout.reshape(-1, shader.OUT), *map(bool, spec[:2]))
    dws, dbs = shader.unpack_grads(dW, dB, spec[2], spec[3])
    got = list(torch.autograd.grad(ws + bs, leaves, dws + dbs))
    shape = (R, S, 3)
    got += [dgeo[:, 0:3].reshape(shape), dgeo[:, 3:6].reshape(shape), dgeo[:, 6:9].reshape(shape),
            dfeats.reshape(R, S, 256)]
    return [a.detach().numpy() for a in want], [b.numpy() for b in got]


def _jax_grads(kw, params_j, inputs, cots):
    cfg = JCfg(fused_shader=False, **kw)
    lut = jnp.asarray(jax_fg_lut())

    def loss(p, pts, nrm, view, ft):
        c, o = jax_apply(p, cfg, lut, pts, nrm, view, ft, jnp.asarray(inputs["hp"]))
        return jnp.sum(c * cots[0]) + jnp.sum(o["occ_prob"] * cots[1])
    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        params_j, *[jnp.asarray(inputs[k]) for k in ("pts", "normals", "view", "feats")])
    gp = jax.tree_util.tree_map(np.asarray, g[0])
    return [a for _, a in tree_items(gp)] + [np.asarray(a) for a in g[1:]]


def _cosines(ga, gb):
    out = []
    for a, b in zip(ga, gb):
        a, b = a.ravel(), b.ravel()
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        out.append(float(a @ b / denom) if denom >= 1e-12 else 1.0)
    return out


@pytest.mark.parametrize("reference", ["plain", "xla"])
def test_rounding_points_hold_the_bar(setup, reference):
    """Every param leaf, pts, normals, view and feats: the emulated kernel
    backward within cosine 0.99 (human: 0.98) of the f32 gradients of the
    port's plain version or of nero_tpu's XLA shader."""
    variant, kw, params_j, inputs, cots = setup
    want, got = _reference_and_emulated(kw, params_j, inputs, cots)
    if reference == "xla":
        want = _jax_grads(kw, params_j, inputs, cots)
    bar = 0.98 if kw.get("human_light") else 0.99
    cos = _cosines(want, got)
    assert min(cos) > bar, (variant, reference, min(cos), int(np.argmin(cos)))
    # the emulation is no copy of the reference: bf16 moves every leaf a little
    assert max(float(np.abs(a - b).max()) for a, b in zip(want, got)) > 0.0


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_zero_rows_give_zero_parameter_gradients(variant):
    """No rows: empty packed outputs and every parameter gradient exactly 0
    (the CPU side of the wrapper; on the card the kernels are not launched
    and dW, dB stay zero)."""
    kw, params_j, _, _ = _setup(variant)
    cfg = AppShadingConfig(**kw)
    p = from_numpy_tree(params_j)
    z3, z256 = torch.zeros(0, 3), torch.zeros(0, 256)
    hp = torch.zeros(0, 3, 4) if cfg.human_light else None
    raw = shader.shader_raw(p, cfg, z3, z3, z3, z256, hp)
    assert raw.shape == (0, shader.OUT)
    leaves = [v for _, v in tree_items(p)]
    for g, leaf in zip(torch.autograd.grad(raw.sum(), leaves, allow_unused=True), leaves):
        assert g is None or (g.shape == leaf.shape and not g.any())


# ---------------------------------------------------------------------------
# the backward's buffers: a mirror of csrc/shader.cu's layout
# ---------------------------------------------------------------------------


def _source_constants() -> dict:
    with open(os.path.join(cuda_build.CSRC, "shader.cu")) as f:
        src = f.read()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in ("PB", "PW_MIN_ROWS", "PW_MAX_CHUNKS")}


def backward_sizes(n: int, sphere: bool, human: bool) -> tuple:
    """(bf16 elements of the scratch, floats of the partials) for n rows: X
    of every input slot, H and GZ of layers 1-3 and GZ4 (16 wide) of every
    head evaluation for n rounded up to the tile; one dW + dB per row chunk."""
    c = _source_constants()
    cfg = AppShadingConfig(sphere_direction=sphere, human_light=human)
    pad = shader.head_pad(cfg)
    slots = [pad["metallic"], pad["outer_light"], pad["outer_light"], pad["inner_light"],
             pad["inner_weight"]] + ([pad["human_light"]] if human else [])
    n_eval = 8 if human else 7
    m = -(-n // c["PB"]) * c["PB"]
    scratch = m * sum(slots) + n_eval * m * (6 * 256 + 16)
    chunks = min(max(m // c["PW_MIN_ROWS"], 1), c["PW_MAX_CHUNKS"])
    heads = shader.head_order(cfg)
    part = chunks * (shader.weight_elems([pad[h] for h in heads]) + len(heads) * 4 * 256)
    return scratch, part


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_backward_buffer_sizes(variant):
    """The mirror at n = 1, 1001, 65,536: the tile and chunk constants the
    source holds, and the sizes they give (1.51 GB of scratch at 65,536 rows
    in the default variant, 1.72 GB with the human head)."""
    kw = VARIANTS[variant]
    sphere, human = bool(kw.get("sphere_direction")), bool(kw.get("human_light"))
    c = _source_constants()
    assert c["PB"] == shader.TILE == 128
    x_row = {(0, 0): 656, (1, 0): 784, (0, 1): 688, (1, 1): 816}[(sphere, human)]
    n_eval = 8 if human else 7
    for n, m, chunks in ((1, 128, 1), (1001, 1024, 1), (65536, 65536, 32)):
        scratch, part = backward_sizes(n, sphere, human)
        assert scratch == m * (x_row + n_eval * 1552)
        w = sum(di * 256 + 2 * 256 * 256 + 256 * 16 for di in shader.head_pad(
            AppShadingConfig(**kw)).values())
        assert part == chunks * (w + (7 if human else 6) * 1024)
    assert abs(backward_sizes(65536, False, False)[0] * 2 / 1e9 - 1.51) < 0.01
    assert abs(backward_sizes(65536, False, True)[0] * 2 / 1e9 - 1.72) < 0.01


# ---------------------------------------------------------------------------
# kernel_variants.py and the ptxas report
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel,name",
                         [("sdf_grad", n) for n in kernel_variants.VARIANTS]
                         + [("shader", n) for n in kernel_variants.SHADER_VARIANTS])
def test_every_variant_patch_applies(kernel, name):
    """A stale patch shows only on the card: each variant's every (old, new)
    pair must find its text in the source as it is, or in the engine's
    header (B1's engine, csrc/sdf_net.cuh), and change it."""
    files = kernel_variants.variant_files(name, kernel)
    allowed = {f"{kernel}.cu", *kernel_variants._HEADERS.get(kernel, ())}
    assert f"{kernel}.cu" in files and set(files) <= allowed
    changed = False
    for fn, text in files.items():
        with open(os.path.join(cuda_build.CSRC, fn)) as f:
            changed = changed or text != f.read()
    table = kernel_variants.VARIANTS if kernel == "sdf_grad" else kernel_variants.SHADER_VARIANTS
    assert changed == bool(table[name])


def test_ptxas_info_takes_the_template_instance(tmp_path, monkeypatch):
    """chip_smoke.py reads each shader variant's backward kernels by their
    template arguments (Var<sphere, human> mangles as Lb<0|1>ELb<0|1>E)."""
    log = tmp_path / "lib.so.log"
    entry = ("ptxas info    : Compiling entry function "
             "'_ZN12_GLOBAL__N_123shader_bwd_sweep_kernelINS_3VarILb{}ELb{}EEEEvPKf' for 'sm_90a'\n"
             "    0 bytes stack frame, {} bytes spill stores, 0 bytes spill loads\n"
             "ptxas info    : Used {} registers, used 1 barriers\n")
    log.write_text(entry.format(0, 0, 0, 120) + entry.format(1, 1, 8, 128))
    monkeypatch.setattr(cuda_build, "_lib_path", lambda name: str(tmp_path / "lib.so"))
    assert cuda_build.ptxas_info("shader", r"shader_bwd_sweep_kernel\w*Lb1ELb1E") == {
        "regs": 128, "spill_bytes": 8}
    assert cuda_build.ptxas_info("shader", r"shader_bwd_sweep_kernel\w*Lb0ELb0E") == {
        "regs": 120, "spill_bytes": 0}
    assert cuda_build.ptxas_info("shader", r"shader_bwd_sweep_kernel\w*Lb0ELb1E") == {}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cuda_backward_matches_plain_and_emulation(variant):
    """n = 1001 (ragged for both tiles) and 0: the kernel's gradients against
    the plain version (cosine 0.99, human 0.98) and against the emulated
    rounding points (cosine 0.9999); the library's buffer sizes equal the
    mirror; two backward calls give the same dW to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    kw, params_j, _, _ = _setup(variant)
    cfg = AppShadingConfig(**kw)
    dev = torch.device("cuda")
    sphere, human = int(cfg.sphere_direction), int(cfg.human_light)
    lib = shader._lib()
    for n in (1, 1001, 65536):
        assert (lib.shader_scratch_elems(n, sphere, human),
                lib.shader_part_elems(n, sphere, human)) == backward_sizes(n, sphere, human)
    p = from_numpy_tree(params_j, device=dev)
    rng = np.random.default_rng(5)
    n = 1001
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    hp = t(np.concatenate([q, rng.uniform(-0.5, 0.5, (n, 3, 1))], -1)) if human else None
    xs = [t(rng.uniform(-0.6, 0.6, (n, 3))), t(rng.standard_normal((n, 3))),
          t(rng.standard_normal((n, 3))), t(rng.standard_normal((n, 256)) * 0.3)]
    gout = t(rng.standard_normal((n, shader.OUT)))
    with torch.no_grad():
        geo, feats, spec, ws, bs = shader.kernel_inputs(p, cfg, *xs, hp)
        W, B = shader.pack_weights(ws, bs, spec[2])
        got = shader._bwd(geo, feats, W, B, sphere, human, gout)
        again = shader._bwd(geo, feats, W, B, sphere, human, gout)
        emu = emulate_shader_bwd(W.cpu(), B.cpu(), geo.cpu(), feats.cpu(), gout.cpu(),
                                 bool(sphere), bool(human))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    bar = 0.98 if human else 0.99
    xs_g = [x.clone().requires_grad_(True) for x in xs]
    leaves = [v for _, v in tree_items(p)]
    raw = shader.shader_raw_plain(p, cfg, *xs_g, hp)
    want = torch.autograd.grad(raw, leaves + xs_g, gout)
    dws, dbs = shader.unpack_grads(got[2], got[3], spec[2], spec[3])
    # the kernel's dW, dB to the parameter leaves through the weight norm,
    # resolved again with autograd on (the launches above ran without it)
    ws_g, bs_g = shader.kernel_inputs(p, cfg, *xs, hp)[3:]
    mine = list(torch.autograd.grad(ws_g + bs_g, leaves, dws + dbs, allow_unused=True))
    mine += [got[0][:, 0:3], got[0][:, 3:6], got[0][:, 6:9], got[1]]
    assert min(_cosines([a.cpu().numpy() for a in want], [b.cpu().numpy() for b in mine])) > bar
    assert min(_cosines([a.numpy() for a in emu], [b.cpu().numpy() for b in got])) > 0.9999
    z = shader._bwd(geo[:0], feats[:0], W, B, sphere, human, gout[:0])
    assert z[0].shape == (0, 9) and not z[2].any() and not z[3].any()
