"""invert_ms: milliseconds of one PV inversion alone (the spectral solve,
or the multigrid to its tolerance), on the final state's q from its psi,
between two CUDA events over repeated calls."""

CALLS = 10


def read(run):
    if not run.cuda:
        return None
    state, system = run.state, run.system
    return run.device_ms(lambda: system.invert(state), CALLS)
