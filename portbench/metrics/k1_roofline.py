"""k1_roofline: the tendency kernel K1's share of its roofline, in percent:
the least time of its bytes and operations (the benchmark's own count,
work.k1_work, at the cell's shapes) against the card's published peaks,
over its time between CUDA events, alone on the final state's psi."""

from portbench import work

CALLS = 50


def read(run):
    if not run.cuda:
        return None
    cfg, state, system = run.system.cfg, run.state, run.system
    itemsize = state.psi.element_size()
    nbytes, nops = work.k1_work(cfg.N, cfg.nl, itemsize, iRe=cfg.iRe,
                                iRe4=cfg.iRe4)
    ms = run.device_ms(lambda: system.tendency(state), CALLS)
    return work.least_seconds(nbytes, nops, itemsize) * 1e3 / ms * 100.0
