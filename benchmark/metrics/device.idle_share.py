"""The share of a step in which no kernel or memory operation runs on the
card: 100 x (1 - the union of device activity a step in the traced span /
the step period of the run's window), as nero_tpu_torch's `profile_step.py`
counts it (the profiler's own host work lengthens the traced steps, so
their period is taken from the window, which no profiler slows)."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"


def read(record):
    tr = record["trace"]
    if tr is None or not record["window_steps"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["steps"] / record["step_period_s"])
