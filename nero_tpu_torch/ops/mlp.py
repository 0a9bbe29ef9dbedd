"""Weight-norm dense layers and MLP heads as plain dicts of tensors.

Counterpart of nero_tpu/ops/mlp.py. A dense layer is `{v [in,out], g [1,out],
b [out]}` with w = g * v / ||v|| (norm over the fan-in axis), or `{w, b}`
without weight norm. The {v, g, b} leaves are what the optimizer updates;
`resolve_weight_norm` materialises w once per step and autograd chains back
to v and g through it (nero_tpu/ops/mlp.py:124-142).

Initialisers draw from an explicit `torch.Generator` on the CPU and move the
result to the requested device, so a seed gives the same weights on any
device (they differ from nero_tpu's jax.random draws; tests convert weights
with core/convert.py instead).

Two per-thread contexts set the precision of the plain MLP paths, as
nero_tpu's hidden-storage context and its matmul precision do:

* `hidden_dtype(dtype)`: the storage of hidden activations
  (nero_tpu/ops/mlp.py:28-73). `cast_hidden` rounds an activation to it at
  nero_tpu's points (a head's input and each ReLU output; the SDF's in
  fields/sdf.py). Outside any context nothing is cast.
* `product_mode(mode)`: how `apply_dense` multiplies. "f32": f32 operands (a
  bf16 input is widened exactly, as `jnp.dot` promotes it); "tf32": the
  f32 product with the card's TF32 flag on, for every f32 matrix product
  inside the context; "bf16": bf16 operands, f32 accumulation and an f32
  result, forward and backward, as `jnp.dot(..., preferred_element_type=
  f32)` under JAX's default precision on a TPU (nero_tpu/ops/mlp.py:113-121).
  `resolve_matmul_precision(name, device)` maps nero_tpu's names to a mode:
  on the CPU every name computes in f32, as XLA:CPU does.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# precision contexts
# ---------------------------------------------------------------------------

_CONTEXT = threading.local()

# nero_tpu's `matmul_precision` names (JAX's) -> the product mode on CUDA
MATMUL_PRECISIONS = {"highest": "f32", "float32": "f32",
                     "high": "tf32", "tensorfloat32": "tf32", "bfloat16_3x": "tf32",
                     "default": "bf16", "bfloat16": "bf16", "fastest": "bf16"}
PRODUCT_MODES = ("f32", "tf32", "bf16")


def _stack(name: str) -> list:
    if not hasattr(_CONTEXT, name):
        setattr(_CONTEXT, name, [None])
    return getattr(_CONTEXT, name)


@contextlib.contextmanager
def hidden_dtype(dtype):
    """Store hidden activations in `dtype` (torch.bfloat16 or torch.float32)
    inside the context; None leaves them as they are."""
    s = _stack("hidden")
    s.append(dtype)
    try:
        yield
    finally:
        s.pop()


def cast_hidden(x: torch.Tensor) -> torch.Tensor:
    """Round a hidden activation to the context's storage dtype (no-op outside)."""
    dt = _stack("hidden")[-1]
    return x if dt is None or x.dtype == dt else x.to(dt)


def current_hidden_dtype():
    """The storage dtype of the innermost context, None outside any."""
    return _stack("hidden")[-1]


def storage_dtype(bf16_hidden, device) -> torch.dtype:
    """Resolve a `bf16_hidden` key: true -> bf16, false -> f32, unset -> bf16
    on CUDA, the port's accelerator, and f32 elsewhere, as nero_tpu's unset
    means bf16 on a TPU only (render/shape.py:128-131)."""
    if bf16_hidden is None:
        on = torch.device(device).type == "cuda"
    elif isinstance(bf16_hidden, bool):
        on = bf16_hidden
    else:
        raise ValueError(f"bf16_hidden must be true, false or unset, got {bf16_hidden!r}")
    return torch.bfloat16 if on else torch.float32


def resolve_matmul_precision(name: str, device) -> str:
    """nero_tpu's `matmul_precision` name -> the product mode on `device`:
    on CUDA the mode of MATMUL_PRECISIONS, on the CPU always "f32"."""
    if name not in MATMUL_PRECISIONS:
        raise ValueError(f"matmul_precision must be one of {sorted(MATMUL_PRECISIONS)}, "
                         f"got {name!r}")
    return MATMUL_PRECISIONS[name] if torch.device(device).type == "cuda" else "f32"


def set_tf32(on: bool) -> bool:
    """Set the CUDA matmul TF32 flag, returning its previous state. Uses the
    `fp32_precision` setting where PyTorch has it (it refuses a mix of that
    and the older `allow_tf32`)."""
    m = torch.backends.cuda.matmul
    if hasattr(m, "fp32_precision"):
        was = m.fp32_precision == "tf32"
        m.fp32_precision = "tf32" if on else "ieee"
    else:
        was = bool(m.allow_tf32)
        m.allow_tf32 = on
    return was


def current_product_mode() -> str:
    return _stack("product")[-1] or "f32"


@contextlib.contextmanager
def product_mode(mode: str):
    """Multiply in `mode` ("f32", "tf32" or "bf16") inside the context; the
    TF32 flag is on exactly inside a "tf32" context and restored on exit."""
    if mode not in PRODUCT_MODES:
        raise ValueError(f"product mode {mode!r}")
    s = _stack("product")
    s.append(mode)
    was = set_tf32(mode == "tf32")
    try:
        yield
    finally:
        set_tf32(was)
        s.pop()


def current_precision() -> tuple:
    """The innermost storage dtype and product mode of this thread (None
    for either outside its context), for `precision_of` to re-enter."""
    return _stack("hidden")[-1], _stack("product")[-1]


@contextlib.contextmanager
def precision_of(state: tuple):
    """Re-enter a `current_precision()` state. Autograd runs the backward of
    CUDA tensors on a device thread of its own, where the contexts of the
    thread that built the graph are not seen: a function recomputed there
    (torch.utils.checkpoint) enters the forward's state again through this."""
    storage, mode = state
    with hidden_dtype(storage), (contextlib.nullcontext() if mode is None
                                 else product_mode(mode)):
        yield


def scaled(t: torch.Tensor, s) -> torch.Tensor:
    """t * s for s a Python number or a 0-d f32 tensor (a training step's
    per-step number, core/step_graph.py), with the same bits either way:
    PyTorch multiplies a bfloat16 or half tensor by a Python number in f32,
    and by a 0-d tensor of another dtype in t's dtype."""
    if isinstance(s, torch.Tensor) and s.dtype != t.dtype:
        return (t.to(s.dtype) * s).to(t.dtype)
    return t * s


def _mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[m,k] @ [k,n] on bf16 operands with f32 accumulation and an f32
    result. On the CPU the operands are rounded to bf16 and multiplied in
    f32, where each product of two bf16 values is exact."""
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _Bf16Product(torch.autograd.Function):
    """x @ w in the "bf16" mode, each cotangent product in that mode too, as
    JAX transposes a dot under its default precision. Its backward is made
    of the same products, so it differentiates again (the spatial SDF
    gradient under the training gradient)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_bf16(x, w)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = bf16_product(gy, w.t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = bf16_product(x.t(), gy).to(w.dtype)
        return gx, gw


def bf16_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _Bf16Product.apply(x, w)


def dense_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ w [in, out] -> f32, in the context's product mode."""
    if current_product_mode() != "bf16":
        return x.float() @ w
    y = bf16_product(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[1])



def torch_default_weight(gen: torch.Generator, d_in: int, d_out: int) -> torch.Tensor:
    bound = 1.0 / math.sqrt(d_in)
    return (torch.rand(d_in, d_out, generator=gen) * 2.0 - 1.0) * bound


def torch_default_bias(gen: torch.Generator, d_in: int, d_out: int) -> torch.Tensor:
    bound = 1.0 / math.sqrt(d_in)
    return (torch.rand(d_out, generator=gen) * 2.0 - 1.0) * bound


def normal_weight(gen: torch.Generator, d_in: int, d_out: int, mean: float = 0.0,
                  std: float = 1.0) -> torch.Tensor:
    return mean + std * torch.randn(d_in, d_out, generator=gen)


def init_dense(gen: torch.Generator, d_in: int, d_out: int, *, weight_norm: bool = True,
               weight: torch.Tensor | None = None, bias=None, device="cpu"):
    w = torch_default_weight(gen, d_in, d_out) if weight is None else weight
    b = torch_default_bias(gen, d_in, d_out) if bias is None else torch.as_tensor(bias)
    b = torch.broadcast_to(b, (d_out,)).float().clone()
    w = w.float()
    if weight_norm:
        g = torch.linalg.norm(w, dim=0, keepdim=True)
        layer = {"v": w, "g": g, "b": b}
    else:
        layer = {"w": w, "b": b}
    return {k: t.to(device).requires_grad_(True) for k, t in layer.items()}


def resolve_dense(layer: dict) -> dict:
    """{v, g, b} -> {w = g v / |v|, b}; a layer stacked on a leading scene
    axis (v [S, in, out], parallel/scenes.py) is resolved scene by scene, as
    one scene's is."""
    if "v" in layer:
        v, g = layer["v"], layer["g"]
        if v.dim() == 3:
            return {"w": torch.stack([_resolve_w(v[s], g[s]) for s in range(v.shape[0])]),
                    "b": layer["b"]}
        return {"w": _resolve_w(v, g), "b": layer["b"]}
    return layer


def _resolve_w(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.norm(v, dim=0, keepdim=True)
    return g * v / torch.clamp(norm, min=1e-12)


def resolve_weight_norm(params):
    """Materialise weight-norm layers ({v,g,b} -> {w,b}) across a param tree."""
    if isinstance(params, dict):
        if "v" in params and "g" in params:
            return resolve_dense(params)
        return {k: resolve_weight_norm(x) for k, x in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(resolve_weight_norm(x) for x in params)
    return params


def apply_dense(layer: dict, x: torch.Tensor) -> torch.Tensor:
    w = resolve_dense(layer)["w"]
    return dense_product(x, w) + layer["b"]


def softplus_beta(x: torch.Tensor, beta: float = 100.0) -> torch.Tensor:
    """softplus(beta x) / beta (linear above beta x = 20, where the two
    differ by < 3e-11 after the 1/beta scale)."""
    return F.softplus(x, beta=beta)


def exp_activation(x: torch.Tensor, max_light: float = 5.0) -> torch.Tensor:
    """exp with an upper clamp on the pre-activation (light heads)."""
    return torch.exp(torch.clamp(x, max=max_light))


def init_predictor(gen: torch.Generator, d_in: int, d_out: int, *, weight_norm: bool = True,
                   run_dim: int = 256, final_bias: float | None = None, device="cpu"):
    """Linear(d_in,256) ReLU Linear ReLU Linear ReLU Linear(256,d_out)."""
    dims = [(d_in, run_dim), (run_dim, run_dim), (run_dim, run_dim), (run_dim, d_out)]
    layers = [init_dense(gen, di, do, weight_norm=weight_norm, device=device)
              for di, do in dims]
    if final_bias is not None:
        with torch.no_grad():
            layers[-1]["b"].fill_(final_bias)
    return layers


def predictor_raw(layers, x: torch.Tensor) -> torch.Tensor:
    """The 4-layer head without its final activation; the input and each
    ReLU output in the storage dtype (nero_tpu/ops/mlp.py:203-206)."""
    h = cast_hidden(x)
    for layer in layers[:-1]:
        h = cast_hidden(torch.relu(apply_dense(layer, h)))
    return apply_dense(layers[-1], h)


def apply_predictor(layers, x: torch.Tensor, activation: str = "sigmoid",
                    exp_max: float = 0.0, fused: bool = False) -> torch.Tensor:
    """The 4-layer head with its final activation: 'sigmoid', 'exp' (clamped
    at exp_max) or 'none'. `fused` sends the linear/ReLU body through the
    predictor kernel (ops/predictor.py: on a CUDA tensor the kernel, on a CPU
    tensor its plain version); the activation stays here either way."""
    if fused:
        from nero_tpu_torch.ops.predictor import predictor
        h = predictor(layers, x)
    else:
        h = predictor_raw(layers, x)
    if activation == "exp":
        return exp_activation(h, exp_max)
    if activation == "sigmoid":
        return torch.sigmoid(h)
    if activation == "none":
        return h
    raise NotImplementedError(activation)
