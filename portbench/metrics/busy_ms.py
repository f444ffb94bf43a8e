"""busy_ms: milliseconds a step in which an operation ran on the device,
over the traced window: the union of the device operations' intervals
over the steps the window took. Where the host paces the step, it moves
with the device's work alone, and spreads less than the step's wall
time."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return run.trace.busy_s / run.trace_steps * 1e3
