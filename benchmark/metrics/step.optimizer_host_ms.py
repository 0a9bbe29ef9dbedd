"""Host milliseconds a step in `zero_grad` and Adam's step
(`nero.step.optimizer`), by the program's spans in the traced steps."""
from benchmark.harness.spans import host_ms

LAYER = "model step"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_rays_per_s"


def read(record):
    return host_ms(lambda name: name == "nero.step.optimizer")
