"""idle_share: the share of the traced window in which no operation ran on
the device, in percent: 1 - (union of the device operations' intervals)
/ (the window's length)."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return (1.0 - run.trace.busy_s / run.trace.window_s) * 100.0
