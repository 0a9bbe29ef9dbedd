"""B1's share of its roofline: the least time for the work
benchmark/work/sdf_grad.py counts (frozen in the workload's `work`) over
the device time a step of B1's kernels."""
from benchmark.work.peaks import least_seconds

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"
FAMILY = "sdf_grad"


def read(record):
    tr = record["trace"]
    work = record["work"].get(FAMILY)
    if tr is None or work is None or not tr["family_s"].get(FAMILY):
        return None
    least = least_seconds(work["flops"], work["bytes"], record["kind"])
    if least is None:
        return None
    return 100.0 * least / (tr["family_s"][FAMILY] / tr["steps"])
