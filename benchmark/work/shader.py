"""B2: NeRO's split-sum shader at N rows, forward and the training backward
(nero_tpu_torch's `ops/shader.py`, `csrc/shader.cu`).

The work counted is the heads' products: each 4-layer head (d_in -> 256 ->
256 -> 256 -> d_out) a row, the outer-light head twice (normal and
reflected direction). The backward takes every dW, the hidden layers'
input cotangents, and the first layer's input cotangent for the columns
that carry a gradient: the SDF's features (not the point) into the
material heads, the IDE into the light heads (not the light head's
positional encoding of the point), the human light's IPE; the occlusion
head's input is detached. The encodings' arithmetic is not counted, so
the count is below the least work, never above it.

The bytes: the f32 rows in (point, normal, view, 256 features, and the
human frame for that variant) and the 24 packed outputs; the cotangents of
the outputs in and of the normals and features out; the weights in f32
and their f32 gradients.
"""
from __future__ import annotations

from benchmark.harness.weights import head_shapes
from benchmark.reference.encodings import ide_dim

HID = 256


def _grad_inputs(name: str, d_in: int, shader: dict) -> int:
    """Columns of a head's input that carry a gradient."""
    if name in ("metallic", "roughness", "albedo"):
        return d_in - 3
    if name in ("outer_light", "inner_light"):
        return ide_dim(shader.get("ide_deg", 5))
    if name == "human_light":
        return d_in
    return 0


def macs_per_row(shader: dict) -> dict:
    fwd = bwd = 0
    for name, (d_in, d_out, _) in head_shapes(shader).items():
        evals = 2 if name == "outer_light" else 1
        body = d_in * HID + 2 * HID * HID + HID * d_out
        fwd += evals * body
        bwd += evals * (body + 2 * HID * HID + HID * d_out + _grad_inputs(name, d_in, shader) * HID)
    return {"forward": fwd, "backward": bwd}


def flops(n: int, shader: dict) -> float:
    return 2.0 * n * sum(macs_per_row(shader).values())


def min_bytes(n: int, shader: dict) -> float:
    weights = sum(3 * HID + (d_in + 2 * HID) * HID + HID * d_out + d_out
                  for d_in, d_out, _ in head_shapes(shader).values())
    rows_in = 3 + 3 + 3 + HID + (12 if shader.get("human_light", False) else 0)
    per_row = rows_in + 24 + 24 + 3 + HID
    return 4.0 * (n * per_row + 2 * weights)
