"""Host milliseconds a step in the occlusion loss (`nero.render.occ`: the
candidates and the occlusion march), by the program's spans in the traced
steps."""
from benchmark.harness.spans import host_ms

LAYER = "renderer and fields"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_rays_per_s"


def read(record):
    return host_ms(lambda name: name == "nero.render.occ")
