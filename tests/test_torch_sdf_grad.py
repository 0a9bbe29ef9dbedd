"""SDF with spatial gradient: the port's plain version (the CPU side of
ops/sdf_grad.py) against nero_tpu's XLA `sdf_with_grad` in f32, and against
the TPU kernel `sdf_with_grad_fused` in interpret mode at the bars of
tests/test_sdf_grad_kernel.py. The CUDA kernel itself is held against the
plain version on the card by chip_smoke.py and by the `gpu`-marked test; its
backward's rounding points, emulated in plain torch (`emulate_kernel_bwd`),
are held here at chip_smoke.py's bar."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nero_tpu.fields.sdf import SDFConfig as JSDFConfig, init_sdf, sdf_with_grad as jax_swg
from nero_tpu.ops.pallas.sdf_grad_kernel import sdf_with_grad_fused
from nero_tpu_torch.core.convert import from_numpy_tree, tree_items
from nero_tpu_torch.fields.sdf import SDFConfig
from nero_tpu_torch.ops import sdf_grad


@pytest.fixture(scope="module")
def setup():
    params_j = init_sdf(jax.random.PRNGKey(3), JSDFConfig())
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.7, 0.7, (256, 3)).astype(np.float32)
    cot = (rng.standard_normal((256, 256)) * 0.1).astype(np.float32)
    return params_j, pts, cot


def _jax_loss(fn, pts, cot, **kw):
    def loss(p):
        sdf, feats, grad = fn(p, jnp.asarray(pts), JSDFConfig(), **kw)
        eik = jnp.mean((jnp.linalg.norm(grad, axis=-1) - 1.0) ** 2)
        return jnp.mean(sdf ** 2) + 0.1 * eik + jnp.mean(feats * jnp.asarray(cot))
    return loss


def _port_grads(params_j, pts, cot):
    p = from_numpy_tree(jax.tree_util.tree_map(np.asarray, params_j))
    sdf, feats, grad = sdf_grad.sdf_with_grad(p, torch.from_numpy(pts), SDFConfig())
    eik = ((torch.linalg.norm(grad, dim=-1) - 1.0) ** 2).mean()
    loss = (sdf ** 2).mean() + 0.1 * eik + (feats * torch.from_numpy(cot)).mean()
    loss.backward()
    return loss.item(), {k: v.grad.numpy() for k, v in tree_items(p)}


def test_cpu_wrapper_runs_plain_version(setup):
    params_j, pts, _ = setup
    p = from_numpy_tree(jax.tree_util.tree_map(np.asarray, params_j))
    x = torch.from_numpy(pts)
    with torch.no_grad():
        a = sdf_grad.sdf_with_grad(p, x, SDFConfig())
        b = sdf_grad.sdf_with_grad_plain(p, x, SDFConfig())
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
def test_forward(setup, reference):
    params_j, pts, _ = setup
    if reference == "xla":
        ref = jax_swg(params_j, jnp.asarray(pts), JSDFConfig())
        tol = dict(sdf=(1e-5, 1e-4), grad=(1e-5, 1e-4), feats_mean=1e-6)
    else:
        ref = sdf_with_grad_fused(params_j, jnp.asarray(pts), JSDFConfig(), interpret=True)
        tol = dict(sdf=(5e-3, 1e-2), grad=(2e-2, 5e-2), feats_mean=5e-3)
    p = from_numpy_tree(jax.tree_util.tree_map(np.asarray, params_j))
    with torch.no_grad():
        sdf, feats, grad = sdf_grad.sdf_with_grad(p, torch.from_numpy(pts), SDFConfig())
    np.testing.assert_allclose(sdf.numpy(), np.asarray(ref[0]), atol=tol["sdf"][0],
                               rtol=tol["sdf"][1])
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref[2]), atol=tol["grad"][0],
                               rtol=tol["grad"][1])
    assert np.abs(feats.numpy() - np.asarray(ref[1])).mean() < tol["feats_mean"]


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
def test_param_grads(setup, reference):
    """mean(sdf^2) + 0.1 eikonal + mean(feats . cot): every {v,g,b} grad,
    normalised by the leaf's max — 1e-4 against f32 XLA, 2e-2 (the kernel
    test's bar) against the bf16 Pallas kernel."""
    params_j, pts, cot = setup
    if reference == "xla":
        fn, kw, atol = jax_swg, {}, 1e-4
    else:
        fn, kw, atol = sdf_with_grad_fused, {"interpret": True}, 2e-2
    loss_j, g_j = jax.jit(jax.value_and_grad(_jax_loss(fn, pts, cot, **kw)))(params_j)
    loss_t, g_t = _port_grads(params_j, pts, cot)
    np.testing.assert_allclose(loss_t, float(loss_j), rtol=1e-4 if reference == "xla" else 1e-2)
    for k, a in tree_items(jax.tree_util.tree_map(np.asarray, g_j)):
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(g_t[k] / scale, a / scale, atol=atol, err_msg=k)


def test_zero_rows(setup):
    """No points: empty outputs of the right widths and parameter gradients
    that are exactly zero (the kernel's zero-row case on the card)."""
    params_j, _, _ = setup
    p = from_numpy_tree(jax.tree_util.tree_map(np.asarray, params_j))
    sdf, feats, grad = sdf_grad.sdf_with_grad(p, torch.zeros(0, 3), SDFConfig())
    assert sdf.shape == (0, 1) and feats.shape == (0, 256) and grad.shape == (0, 3)
    leaves = [v for _, v in tree_items(p)]
    gs = torch.autograd.grad(sdf.sum() + feats.sum() + grad.sum(), leaves)
    for g, leaf in zip(gs, leaves):
        assert g.shape == leaf.shape and not g.any()


def test_pack_unpack_round_trip(setup):
    params_j, _, _ = setup
    from nero_tpu_torch.ops.mlp import resolve_weight_norm
    layers = resolve_weight_norm(from_numpy_tree(jax.tree_util.tree_map(np.asarray, params_j),
                                                 requires_grad=False))
    ws, bs = [l["w"] for l in layers], [l["b"] for l in layers]
    W, b = sdf_grad.pack_weights(ws, bs)
    dws, dbs = sdf_grad.unpack_grads(W.float(), b)
    # unpack applies the skip layer's 1/sqrt(2) a second time, as the chain rule does
    for l, (w, d) in enumerate(zip(ws, dws)):
        want = w / 2.0 if l == 4 else w
        np.testing.assert_allclose(d.numpy(), want.numpy(), atol=8e-3 * float(w.abs().max()))
    for b0, d in zip(bs, dbs):
        np.testing.assert_array_equal(d.numpy(), b0.numpy())


def test_ptxas_info_reads_the_build_log(tmp_path, monkeypatch):
    """chip_smoke.py reports each B1 kernel's registers and spill bytes from
    the nvcc log; the parser takes the entry function it is asked for."""
    from nero_tpu_torch.ops import cuda_build
    log = tmp_path / "lib.so.log"
    log.write_text(
        "ptxas info    : Compiling entry function '_ZN20sdf_bwd_sweep_kernelEv' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 96 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN19sdf_grad_fwd_kernelEv' for 'sm_90a'\n"
        "    32 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers\n")
    monkeypatch.setattr(cuda_build, "_lib_path", lambda name: str(tmp_path / "lib.so"))
    assert cuda_build.ptxas_info("sdf_grad", "sdf_grad_fwd_kernel") == {"regs": 128,
                                                                       "spill_bytes": 28}
    assert cuda_build.ptxas_info("sdf_grad", "sdf_bwd_sweep_kernel") == {"regs": 96,
                                                                        "spill_bytes": 0}
    assert cuda_build.ptxas_info("sdf_grad", "missing_kernel") == {}
    monkeypatch.setattr(cuda_build, "_lib_path", lambda name: str(tmp_path / "none.so"))
    assert cuda_build.ptxas_info("sdf_grad", "sdf_grad_fwd_kernel") == {}


def _bf(x):
    return x.to(torch.bfloat16).float()


def _pe_rows(pts, scale):
    """[4n, 48]: PE(6) of the scaled points, then its d/dx, d/dy, d/dz rows
    (w.r.t. the unscaled points), as csrc/sdf_grad.cu::pe_tile builds them."""
    n = pts.shape[0]
    out = torch.zeros(4, n, sdf_grad.PE_W)
    xs = pts * scale
    out[0, :, :3] = xs
    for j in range(3):
        out[1 + j, :, j] = scale
    for i in range(6):
        f = 2.0 ** i
        for k in range(3):
            x = xs[:, k] * f
            out[0, :, 3 + 6 * i + k] = torch.sin(x)
            out[0, :, 6 + 6 * i + k] = torch.cos(x)
            out[1 + k, :, 3 + 6 * i + k] = scale * f * torch.cos(x)
            out[1 + k, :, 6 + 6 * i + k] = -scale * f * torch.sin(x)
    return out.reshape(4 * n, sdf_grad.PE_W)


def emulate_kernel_bwd(W, bias, beta, scale, pts, g_sdf, g_grad, g_feats):
    """The backward of csrc/sdf_grad.cu in plain torch with its rounding
    points: bf16 operands and f32 sums; the sweep's GZ and layer 8's
    cotangent rows are bf16. The recompute stores the forward's
    H = bf16(act(z)), the sweep takes s = 1 - exp(-beta h_p) and the
    tangents' sum over h_t = s z_t from it, and the parameter pass uses it.
    Rows are stacked kind-major [4n]. Returns (dW packed f32, db [9, 272])."""
    n = pts.shape[0]
    sizes = [r * c for r, c in sdf_grad.PACK_SHAPES]
    w = [t.view(r, c).float() for t, (r, c) in zip(torch.split(W, sizes), sdf_grad.PACK_SHAPES)]
    w0, w1, w2, w3, w4a, w4b, w5, w6, w7, w8 = w
    primal = (torch.arange(4 * n) < n)[:, None].float()
    col = torch.arange(sdf_grad.HID)

    def act(z, l):
        zp = z[:n]
        s = torch.sigmoid(beta * zp)
        h = torch.cat([torch.nn.functional.softplus(beta * zp) / beta, s.repeat(3, 1) * z[n:]])
        return h * (col < sdf_grad.SKIP_W) if l == 3 else h

    pe = _bf(_pe_rows(pts, scale))
    hs, h = [], None
    for l, wl in enumerate([w0, w1, w2, w3, w4a, w5, w6, w7]):
        z = (pe if l == 0 else h) @ wl + (pe @ w4b if l == 4 else 0.0)
        z = z + bias[l, :sdf_grad.HID] * primal
        h = _bf(act(z, l))
        hs.append(h)
    gz8 = torch.zeros(4 * n, sdf_grad.OUT_W)
    gz8[:n, 0] = g_sdf
    gz8[:n, 1:257] = g_feats
    for j in range(3):
        gz8[(j + 1) * n:(j + 2) * n, 0] = g_grad[:, j]
    gz = _bf(gz8)
    gzs = [None] * 8
    for l, wl in zip(range(8, 0, -1), [w8, w7, w6, w5, w4a, w3, w2, w1]):
        gh = gz @ wl.T
        a = hs[l - 1].double()
        s, s2 = -torch.expm1(-beta * a[:n]), beta * torch.exp(-beta * a[:n])
        ghp, ght, at = gh[:n], gh[n:], a[n:]
        mix = sum(at[k * n:(k + 1) * n] * ght[k * n:(k + 1) * n] for k in range(3))
        g = torch.cat([s * ghp + s2 * mix, s.repeat(3, 1) * ght]).float()
        gz = _bf(g * (col < sdf_grad.SKIP_W) if l - 1 == 3 else g)
        gzs[l - 1] = gz
    dws = [pe.T @ gzs[0], hs[0].T @ gzs[1], hs[1].T @ gzs[2], hs[2].T @ gzs[3],
           hs[3].T @ gzs[4], pe.T @ gzs[4], hs[4].T @ gzs[5], hs[5].T @ gzs[6],
           hs[6].T @ gzs[7], hs[7].T @ _bf(gz8)]
    db = torch.zeros(9, sdf_grad.OUT_W)
    for l in range(8):
        db[l, :sdf_grad.HID] = gzs[l][:n].sum(0)
    db[8] = _bf(gz8)[:n].sum(0)
    return torch.cat([d.reshape(-1) for d in dws]), db


@pytest.mark.parametrize("reference", ["plain", "xla"])
def test_kernel_rounding_points_hold_the_bar(setup, reference):
    """The CUDA backward's rounding points, emulated on the CPU, keep every
    {v,g,b} gradient within chip_smoke.py's 2e-2 (max |d| over the leaf's
    max) of the f32 gradients: the port's plain version, or nero_tpu's XLA
    `sdf_with_grad`."""
    params_j, pts, cot = setup
    from nero_tpu_torch.ops.mlp import resolve_weight_norm
    p = from_numpy_tree(jax.tree_util.tree_map(np.asarray, params_j))
    leaves = [v for _, v in tree_items(p)]
    cfg, x, c = SDFConfig(), torch.from_numpy(pts), torch.from_numpy(cot)

    def loss(sdf, feats, grad):
        eik = ((torch.linalg.norm(grad, dim=-1) - 1.0) ** 2).mean()
        return (sdf ** 2).mean() + 0.1 * eik + (feats * c).mean()

    if reference == "plain":
        want = torch.autograd.grad(loss(*sdf_grad.sdf_with_grad_plain(p, x, cfg)), leaves)
    else:
        g_j = jax.jit(jax.grad(_jax_loss(jax_swg, pts, cot)))(params_j)
        g_j = dict(tree_items(jax.tree_util.tree_map(np.asarray, g_j)))
        want = [torch.tensor(g_j[k]) for k, _ in tree_items(p)]
    with torch.no_grad():
        outs = [o.requires_grad_(True) for o in sdf_grad.sdf_with_grad_plain(p, x, cfg)]
    with torch.enable_grad():
        g_sdf, g_feats, g_grad = torch.autograd.grad(loss(*outs), outs)
    layers = resolve_weight_norm(p)
    ws, bs = [l["w"] for l in layers], [l["b"] for l in layers]
    with torch.no_grad():
        W, bias = sdf_grad.pack_weights(ws, bs)
        dW, db = emulate_kernel_bwd(W, bias, cfg.beta, cfg.scale, x, g_sdf[:, 0], g_grad,
                                    g_feats)
    dws, dbs = sdf_grad.unpack_grads(dW, db)
    got = torch.autograd.grad(ws + bs, leaves, dws + dbs)
    for (k, _), a, b in zip(tree_items(p), want, got):
        err = ((a - b).abs().max() / (a.abs().max() + 1e-8)).item()
        assert err <= 2e-2, (k, err)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    p = from_numpy_tree(jax.tree_util.tree_map(
        np.asarray, init_sdf(jax.random.PRNGKey(3), JSDFConfig())), device=dev)
    x = torch.as_tensor(np.random.default_rng(0).uniform(-0.7, 0.7, (4096, 3)),
                        dtype=torch.float32, device=dev)
    with torch.no_grad():
        sdf_k, feats_k, grad_k = sdf_grad.sdf_with_grad(p, x, SDFConfig())
        sdf_p, feats_p, grad_p = sdf_grad.sdf_with_grad_plain(p, x, SDFConfig())
    torch.testing.assert_close(sdf_k, sdf_p, atol=5e-3, rtol=1e-2)
    torch.testing.assert_close(grad_k, grad_p, atol=2e-2, rtol=5e-2)
    assert (feats_k - feats_p).abs().mean() < 5e-3
