"""step_mfu: the whole step's share of the card's peak, in percent: the
least time of the step's mathematics (work.step_work: the fields an update
must read and write, the tendency's operations and the inversion as
fast-transform work, whatever solver or kernel computes it) against the
published peaks, over the untraced window's milliseconds a step."""

from portbench import work


def read(run):
    if not run.cuda:
        return None
    cfg = run.system.cfg
    itemsize = run.state.psi.element_size()
    nbytes, nops = work.step_work(cfg.N, cfg.nl, itemsize, iRe=cfg.iRe,
                                  iRe4=cfg.iRe4)
    return work.least_seconds(nbytes, nops, itemsize) * 1e3 \
        / run.step_ms() * 100.0
