"""The whole step's share of the card's dense bf16 peak: the step's
algorithmic FLOPs (counted with FlopCounterMode on the plain reference step
at the cell's shapes, no recompute, frozen in the workload's `work`) times
the steps of the window, over the window's seconds."""
from benchmark.work.peaks import PEAKS

LAYER = "model step"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "train_rays_per_s"


def read(record):
    peak = PEAKS.get(record["kind"])
    if peak is None or not record["window_steps"]:
        return None
    rate = record["work"]["step_flops"] * record["window_steps"] / record["window_s"]
    return 100.0 * rate / peak["bf16_flops"]
