"""The mean host time of one call of the step (the benchmark's own clock
around each call): what the host spends dispatching a step."""

LAYER = "model step"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_rays_per_s"


def read(record):
    spans = record["host_step_s"]
    return 1e3 * sum(spans) / len(spans) if spans else None
