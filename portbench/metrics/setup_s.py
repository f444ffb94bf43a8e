"""setup_s: seconds from the start of the process to the start of the
window: imports, the kernels' load (and build, in a run that builds),
constants, the initial state, spin-up and warm-up."""


def read(run):
    return run.setup_s
