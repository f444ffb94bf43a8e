"""mg_vcycles: V-cycles of a step's first inversion (the program's
StepDiag.mg_iters), the mean over the steps of the untraced window."""


def read(run):
    cycles = run.system.mg_iters
    if not cycles or not any(cycles):
        return None
    return sum(cycles) / len(cycles)
