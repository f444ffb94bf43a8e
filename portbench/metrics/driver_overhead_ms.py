"""driver_overhead_ms: what the driver loop (run_qg: two host reads a step,
the event bookkeeping) costs a step over the step alone. The same steps
from the same state, profiler off, three times in turns: through the
driver in calls of the cell's length, and as the bare step launched back
to back with one synchronise; the mean difference a step, in
milliseconds."""

ROUNDS = 3


def read(run):
    system, K = run.system, run.mix["steps_per_call"]
    calls = run.mix["trace_calls"]
    steps = calls * K
    start, done = run.state, run.done

    def driven():
        st, d = start, done
        for _ in range(calls):
            st = system.call(st, K, d)
            d += K

    def bare():
        system.bare_steps(start, steps)

    diff = 0.0
    for _ in range(ROUNDS):
        diff += run.host_s(driven) - run.host_s(bare)
    return diff / ROUNDS / steps * 1e3
