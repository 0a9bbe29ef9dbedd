"""The 95th percentile of the step period as the card sees it: the
intervals between consecutive step-end CUDA events of the window, with the
steps dispatched ahead as a training job dispatches them."""
import math

LAYER = "trainer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"


def read(record):
    iv = sorted(record["step_intervals_s"])
    if len(iv) < 20:
        return None
    return 1e3 * iv[math.ceil(0.95 * len(iv)) - 1]
