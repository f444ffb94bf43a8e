#!/usr/bin/env python3
"""Run the fused msqg tendency (K1, msom_tpu_torch/csrc/fused_rhs.cu) on the
CPU, in tools/strip_emulation.py's host emulation of its blocks, against
the port's plain version.

    python3 tools/k1_emulation.py [--early]

The .cu is translated and compiled by g++ as strip_emulation.py does for
K2 (a block's threads are std::threads, a cp.async copy lands at the wait
that retires its group, or with --early at its issue), then called through
its C entry as the wrapper calls it (`fused_rhs.launch`) on CPU tensors: every option set, walled (free and partial slip) and doubly
periodic, the stochastic variant in both, in f64 and f32, at N = 48 (one
strip holds the whole width and height: the periodic halo is the strip's
own interior), 130 (partial strips, one-element copies in f32), 257 (a
last strip of one row and one column) and 64 with nl = 1. Each line gives
an option set's error as a share of its limit (1e-11, 1e-4 of max|dq|
and of umax); above 1 is wrong. Builds go to build/k1_emulation/.
"""

import argparse
import ctypes
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import strip_emulation  # noqa: E402
from msom_tpu_torch.models import fused_rhs, qg  # noqa: E402
from msom_tpu_torch.params import QGConfig  # noqa: E402

OUT = ROOT / "build" / "k1_emulation"
LIMITS = {"float64": 1e-11, "float32": 1e-4}
CASES = [(48, 3), (130, 4), (257, 4), (64, 1)]
FLOW = dict(upg=(0.02, 0.01, 0.0, 0.0), vpg=(0.01, -0.005, 0.0, 0.0))
STOCH = dict(stochastic=True, tr_stoch=50.0)


def build(name, patches=(), early=False, out=OUT) -> Path:
    return strip_emulation.build(name, patches, early, out=out,
                                 source=fused_rhs.SOURCE)


def load(path: Path):
    """The emulated library, declared by the wrapper's own `_lib`."""
    load_ = fused_rhs._build.load
    fused_rhs._build.load = lambda name: ctypes.CDLL(str(path))
    try:
        return fused_rhs._lib.__wrapped__()
    finally:
        fused_rhs._build.load = load_


def run(lib, cfg, const, psi, q):
    """(dq, umax) of the emulated kernel, called as the wrapper calls it."""
    dq = torch.full_like(psi, float("nan"))
    umax = torch.empty((lib.fused_rhs_num_blocks(cfg.N), cfg.nl),
                       dtype=psi.dtype)
    rc = fused_rhs.launch(lib, cfg, const, psi, q, dq, umax, None)
    if rc != 0:
        raise RuntimeError(f"k1_emulation: launch refused ({rc})")
    return dq, umax.amax(dim=0)


def variants(cfg, full):
    """{name: (cfg, const)}: the option sets, cut out of constants built
    with every coupling field and flsrv = 1."""
    no_pg = dict(pp_pad=None, pp=None, zetap_pad=None, umax_pp=None,
                 pp_t=None, zetap_t=None)
    no_topo = dict(topo_pad=None, topo=None, iro=None)
    bare = dataclasses.replace(full, **no_pg, **no_topo, qforc=None)
    ec = dataclasses.replace(cfg, energy_conserv=True)
    st = dataclasses.replace(cfg, **STOCH)
    out = {"uncoupled": (cfg, bare),
           "pg": (cfg, dataclasses.replace(full, **no_topo, zetap_pad=None,
                                           zetap_t=None, qforc=None)),
           "pg_flsrv": (cfg, dataclasses.replace(full, **no_topo,
                                                 qforc=None)),
           "topo": (cfg, dataclasses.replace(full, **no_pg, qforc=None)),
           "qforc": (cfg, dataclasses.replace(full, **no_pg, **no_topo)),
           "energy_conserv": (ec, bare), "energy_conserv_all": (ec, full),
           "stochastic": (st, bare), "stochastic_all": (st, full),
           "all": (cfg, full)}
    if cfg.sbc != -1:
        out["slip_all"] = (dataclasses.replace(cfg, sbc=1.0), full)
    return out


def errors(lib, cases=CASES, periodic=(False, True),
           dtypes=("float64", "float32")):
    """{(periodic, dtype, N, nl, option set): error as a share of its
    limit}."""
    out = {}
    for per in periodic:
        for dtype in dtypes:
            for N, nl in cases:
                cfg = QGConfig(N=N, nl=nl, L0=80, Rom=0.025, Ekb=0.002,
                               Eks=0.001, tau0=1e-4, Re4=391, Re=1000.0,
                               beta=0.5, Fr=(0.003,) * (nl - 1),
                               dh=(1.0 / nl,) * nl, DT=5e-2, tend=1e9,
                               dtout=1e9, CFL=0.6, dtype=dtype,
                               solver="spectral", flsrv=1,
                               sbc=-1.0 if per else 0.0,
                               **{k: v[:nl] for k, v in FLOW.items()}
                               ).validate()
                rng = np.random.default_rng(N + nl)
                full = qg.build_constants(
                    cfg, device="cpu",
                    psipg=0.01 * rng.uniform(-1, 1, (nl, N, N)),
                    topo=0.05 * rng.uniform(-1, 1, (N, N)),
                    qforc=rng.uniform(-1, 1, (nl, N, N)))
                psi = torch.as_tensor(1e-3 * rng.uniform(-1, 1, (nl, N, N)),
                                      dtype=getattr(torch, dtype))
                q = qg.comp_q(cfg, full, psi).contiguous()
                for name, (vcfg, vconst) in variants(cfg, full).items():
                    dq, um = run(lib, vcfg, vconst, psi, q)
                    dq_r, um_r = fused_rhs.rhs_fused_reference(vcfg, vconst,
                                                               psi, q)
                    err = max(((dq - dq_r).abs().max()
                               / dq_r.abs().max()).item(),
                              ((um - um_r).abs() / um_r).max().item())
                    # a NaN (an output never written) is as wrong as can be
                    out[per, dtype, N, nl, name] = (
                        err / LIMITS[dtype] if np.isfinite(err) else np.inf)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--early", action="store_true",
                    help="copies land at their issue, not at their wait")
    args = ap.parse_args()
    lib = load(build("early" if args.early else "late", early=args.early))
    errs = errors(lib)
    for (per, dtype, N, nl, name), e in errs.items():
        print(f"{'periodic' if per else 'walled'} {dtype} N={N} nl={nl} "
              f"{name}: {e:.3e} of the limit{'' if e <= 1 else '  WRONG'}")
    worst = max(errs.values())
    print(f"worst: {worst:.3e} of the limit")
    return 0 if worst <= 1 else 1


if __name__ == "__main__":
    sys.exit(main())
