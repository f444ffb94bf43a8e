"""The reduction of a profiler trace to what the per-layer readers and the
result line read: the device's busy time in the traced window, its kernels
and their time by name, and the idle gaps by what the host was doing.

The traced window is a run of driver calls between two synchronises,
timed on the host's clock, under a profiler that records the device's
activity and the host's CUDA calls only: recording every host operation
as well costs the host about as much time as a step's launches, and the
window would then show idle time that an untraced run does not have.
Device operations are the trace's CUDA events (kernels, copies and
fills); busy time is the union of their intervals. A gap between two of
them is named after the host's CUDA call open at its middle ("host" where
none was: the host was in Python or in PyTorch's own work); the time
before the first operation and after the last is "window edges".
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

TOP = 10


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: int                       # kernel launches in the window
    device_ops: list                   # [[name, seconds]], the most first
    idle_gaps: list                    # [[host activity, seconds]]


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def reduce(events, device_type, window_s: float) -> Trace:
    """Reduce profiler events (`prof.events()`), those on the device
    carrying `device_type`, of a window `window_s` seconds long."""
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if e.device_type == device_type)
    by_name: dict[str, float] = defaultdict(float)
    for a, b, name in dev:
        by_name[name] += b - a
    # union of the device intervals, and the gaps between them (in us)
    busy, gaps, end = 0.0, [], None
    for a, b, _ in dev:
        if end is not None and a > end:
            gaps.append((end, a))
        if end is None or b > end:
            busy += b - (a if end is None else max(a, end))
            end = b
    host = sorted((e.time_range.start, -e.time_range.end, e.name)
                  for e in events if e.device_type != device_type)
    by_host: dict[str, float] = defaultdict(float)
    mids = sorted((0.5 * (a + b), b - a) for a, b in gaps)
    for (_, length), name in zip(mids, _innermost(host, mids)):
        by_host[name] += length
    us = 1e-6
    gap_s = {n: s * us for n, s in by_host.items()}
    edges = window_s - busy * us - sum(gap_s.values())
    if edges > 0:
        gap_s["window edges"] = edges
    return Trace(
        window_s=window_s, busy_s=busy * us,
        kernels=sum(_is_kernel(name) for _, _, name in dev),
        device_ops=[[n[:160], s * us] for n, s in
                    sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=[[n[:160], s] for n, s in
                   sorted(gap_s.items(), key=lambda kv: -kv[1])[:TOP]])


def _innermost(host, mids):
    """For each of the sorted times `mids` (pairs whose first item is the
    time), the name of the innermost host event open then: a sweep over
    the events in order of start, keeping the open ones on a stack, which
    holds where events nest, as a thread's calls do."""
    stack, names, k = [], [], 0
    for t, _ in mids:
        while k < len(host) and host[k][0] <= t:
            while stack and -stack[-1][1] <= host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and -stack[-1][1] <= t:
            stack.pop()
        names.append(stack[-1][2] if stack else "host")
    return names
