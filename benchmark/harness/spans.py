"""What the program's own spans say (nero_tpu_torch/core/trace.py): the
host milliseconds a step inside the spans of some names, from the spans the
traced span's profiled steps recorded (the only stretch of a run with a
profiler on, so the only one whose spans are kept)."""
from __future__ import annotations


def host_ms(match) -> float | None:
    """Inclusive host ms per `nero.step` of every span whose name `match`
    takes; None where the program has no spans, recorded no step, or no
    such span."""
    try:
        from nero_tpu_torch.core.trace import summary
    except ImportError:   # a program without spans
        return None
    s = summary()
    rows = [r for name, r in s["spans"].items() if match(name)]
    if not s["steps"] or not rows:
        return None
    return 1e3 * sum(r["inclusive_s"] for r in rows) / s["steps"]
