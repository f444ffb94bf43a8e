"""step_ms: wall milliseconds a step over the untraced window, every step
that the driver completed in it, from a synchronise to a synchronise."""


def read(run):
    return run.step_ms()
