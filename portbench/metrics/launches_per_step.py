"""launches_per_step: device kernels a step in the traced window, counted
from the profiler's trace (copies and fills not counted)."""


def read(run):
    if run.trace is None or run.trace.kernels == 0:
        return None
    return run.trace.kernels / run.trace_steps
