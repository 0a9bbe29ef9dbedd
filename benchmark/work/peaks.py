"""Published peaks of the cards the benchmark knows, by
`torch.cuda.get_device_name()`: dense bf16 tensor-core FLOP/s (the data
sheet's sparse figures halved) and HBM bytes/s, at the card's full power
limit. A card not listed has no peak: its shares are not reported."""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989.4e12, "hbm_bytes": 3.35e12},
}


def least_seconds(flops: float, nbytes: float, kind: str) -> float | None:
    """The least time the card needs for `flops` and `nbytes`: the larger of
    the two bounds; None for a card without a listed peak."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    return max(flops / peak["bf16_flops"], nbytes / peak["hbm_bytes"])
