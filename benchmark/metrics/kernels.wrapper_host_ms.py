"""Host milliseconds a step in the port's kernel wrappers (every
`nero.kernel.<family>.fwd` and `.bwd`: packing, the launch, unpacking, on
both threads), by the program's spans in the traced steps."""
from benchmark.harness.spans import host_ms

LAYER = "kernels"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_rays_per_s"


def read(record):
    return host_ms(lambda name: name.startswith("nero.kernel."))
