"""What tests/test_torch_shader_bwd.py and tests/test_torch_shader_fwd.py
share: the four variants of the whole-shader kernel, their inputs made from
a seed, and one 4-layer head with the kernel's rounding points (bf16
operands, f32 sums, f32 biases) in plain torch, as csrc/shader.cu rounds
it."""
import jax
import numpy as np
import torch

from nero_tpu.fields.app_shading import AppShadingConfig as JCfg, init_app_shading

R, S = 2, 48
VARIANTS = {"default": dict(), "sphere": dict(sphere_direction=True),
            "human": dict(human_light=True),
            "both": dict(sphere_direction=True, human_light=True)}


def _setup(variant):
    """Random rotations and small translations for the camera frames (hit and
    miss rows of the human light), a few points outside radius 0.999."""
    kw = VARIANTS[variant]
    params_j = jax.tree_util.tree_map(
        np.asarray, init_app_shading(jax.random.PRNGKey(0), JCfg(**kw)))
    rng = np.random.default_rng(11)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    q, _ = np.linalg.qr(rng.standard_normal((R, S, 3, 3)))
    hp = np.concatenate([q, rng.uniform(-0.5, 0.5, (R, S, 3, 1))], -1).astype(np.float32)
    inputs = {"pts": rng.uniform(-0.6, 0.6, (R, S, 3)).astype(np.float32),
              "normals": f(R, S, 3), "view": f(R, S, 3), "feats": f(R, S, 256) * 0.3, "hp": hp}
    inputs["pts"][0, :4] *= 2.5
    return kw, params_j, inputs, (f(R, S, 3), f(R, S, 1))


def _bf(x):
    return x.to(torch.bfloat16).float()


class _KernelHead(torch.autograd.Function):
    """One 4-layer head as the kernels round it: forward, the recompute's
    bf16 input X and activations H = bf16(relu(X W + b)) with f32 sums; the
    sweep's GZ4 = bf16(cotangent), GZ = bf16(mask(H) * (GZ W^T)), dX = GZ1
    W1^T in f32; the parameter pass's dW = X^T GZ and db = sum GZ in f32."""

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
