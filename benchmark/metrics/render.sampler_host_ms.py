"""Host milliseconds a step in the hierarchical sampler (`nero.render.sampler`:
the no-gradient SDF passes and the up-sampling sorts), by the program's
spans in the traced steps."""
from benchmark.harness.spans import host_ms

LAYER = "renderer and fields"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_rays_per_s"


def read(record):
    return host_ms(lambda name: name == "nero.render.sampler")
