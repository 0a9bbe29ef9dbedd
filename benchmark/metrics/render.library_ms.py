"""Device milliseconds a step of every kernel that is not one of the port's
own: the sampler's and the occlusion march's library products, the
background, the elementwise work, Adam."""
from benchmark.harness.trace import port_family

LAYER = "renderer and fields"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"


def read(record):
    tr = record["trace"]
    if tr is None:
        return None
    lib = sum(s for k, s in tr["kernel_s"].items() if port_family(k) is None)
    return 1e3 * lib / tr["steps"]
