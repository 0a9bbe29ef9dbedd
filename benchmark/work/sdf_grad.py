"""B1: the SDF and its spatial gradient at N points, forward and the
training backward (nero_tpu_torch's `ops/sdf_grad.py`, `csrc/sdf_grad.cu`).

The algorithm, in multiply-adds a point, for layers l with (in_l, out_l):

* forward: every layer, sum in_l out_l;
* the gradient d sdf / dx by one reverse sweep: the last layer feeds the
  same column W8[:, 0] to every point, so only layers 0-7 multiply;
* the training backward through the forward: every dW, and the input
  cotangent of every layer but the encoding's columns (layer 0's input and
  the skip's re-entered encoding);
* the training backward through the sweep: for layers 0-7 the products
  that carry the sweep's cotangent forward again, and their dW.

The bytes: the f32 points and the three outputs (sdf, 256 features,
gradient) of the forward; their cotangents into the backward and the f32
weight gradients out of it; the weights read once each way in f32.
"""
from __future__ import annotations

from benchmark.harness.weights import sdf_shapes


def macs_per_point(multires: int = 6) -> dict:
    shapes = sdf_shapes(multires)
    d_enc = shapes[0][0]
    full = sum(i * o for i, o in shapes)
    inner = full - shapes[-1][0] * shapes[-1][1]
    fwd_backward = full + full - 2 * d_enc * shapes[0][1]
    return {"forward": full, "sweep": inner, "backward": fwd_backward + 2 * inner}


def flops(n: int, multires: int = 6) -> float:
    """Operations of the forward, the gradient sweep and the backward at n points."""
    return 2.0 * n * sum(macs_per_point(multires).values())


def min_bytes(n: int, multires: int = 6) -> float:
    weights = sum(i * o + o for i, o in sdf_shapes(multires))
    per_point = 3 + (1 + 256 + 3) + (1 + 256 + 3)
    return 4.0 * (n * per_point + 3 * weights)
