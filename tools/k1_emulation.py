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
last strip of one row and one column) and 64 with nl = 1; then the rows
mode on virtual shards against the plain rows version (ROWS_CASES: 2
shards of 24 rows, 4 of 16). Each line gives
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
# rows mode: {shards: cases}: shards of 24 rows (one partial strip) and of
# 16 (chip_smoke's rows checks add shards of 40: a 32-row strip and an
# 8-row one)
ROWS_CASES = {2: [(48, 3)], 4: [(64, 4)]}
FLOW = dict(upg=(0.02, 0.01, 0.0, 0.0), vpg=(0.01, -0.005, 0.0, 0.0))
STOCH = dict(stochastic=True, tr_stoch=50.0)


# the rows mode's build (csrc/fused_rhs_rows.cu): the source with its rows
# constant on
ROWS = [("#include <cuda_runtime.h>",
         "#define FUSED_RHS_ROWS 1\n#include <cuda_runtime.h>")]


def build(name, patches=(), early=False, out=OUT, rows=False) -> Path:
    return strip_emulation.build(name, (ROWS if rows else []) + list(patches),
                                 early, out=out, source=fused_rhs.SOURCE)


def load(path: Path, rows=False):
    """The emulated library, declared by the wrapper's own `_lib`."""
    load_ = fused_rhs._build.load
    fused_rhs._build.load = lambda name: ctypes.CDLL(str(path))
    try:
        return fused_rhs._lib.__wrapped__(rows)
    finally:
        fused_rhs._build.load = load_


def run(lib, cfg, const, psi, q):
    """(dq, umax) of the emulated kernel, called as the wrapper calls it."""
    dq = torch.full_like(psi, float("nan"))
    umax = torch.empty((lib.fused_rhs_num_blocks(cfg.N, cfg.N), cfg.nl),
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


def rows_run(lib, cfg, const, psi, q, world):
    """(dq, umax) of the emulated rows kernel (`build(rows=True)`) on
    `world` virtual
    shards (each launched with its halo slabs cut from the whole field,
    parallel/halo.split_rows8), put together, and the plain rows version's
    the same way."""
    from msom_tpu_torch.parallel import halo
    N, n = cfg.N, cfg.N // world
    per = cfg.sbc == -1
    p_ext = halo.split_rows8(psi, world, per)
    q_ext = halo.split_rows8(q, world, per)
    got, want = [], []
    for d in range(world):
        rows = slice(d * n, (d + 1) * n)
        dq = torch.full_like(psi[:, rows], float("nan"))
        umax = torch.empty((lib.fused_rhs_num_blocks(N, n), cfg.nl),
                           dtype=psi.dtype)
        rc = fused_rhs.launch(lib, cfg, const, p_ext[d], q_ext[d], dq, umax,
                              None, row0=d * n)
        if rc != 0:
            raise RuntimeError(f"k1_emulation: rows launch refused ({rc})")
        got.append((dq, umax.amax(dim=0)))
        want.append(fused_rhs.rhs_fused_reference(
            cfg, const, psi[:, rows], q[:, rows], psi_ext=p_ext[d],
            q_ext=q_ext[d], row0=d * n))
    return [(torch.cat([g[0] for g in pair], dim=1),
             torch.stack([g[1] for g in pair]).amax(dim=0))
            for pair in (got, want)]


def errors(lib, cases=CASES, periodic=(False, True),
           dtypes=("float64", "float32"), world=None, names=None):
    """{(periodic, dtype, N, nl, option set): error as a share of its
    limit}; with `world` the rows mode on that many virtual shards, and
    `names` a subset of the option sets."""
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
                    if names is not None and name not in names:
                        continue
                    if world is not None:
                        (dq, um), (dq_r, um_r) = rows_run(lib, vcfg, vconst,
                                                          psi, q, world)
                        err = max(((dq - dq_r).abs().max()
                                   / dq_r.abs().max()).item(),
                                  ((um - um_r).abs() / um_r).max().item())
                        out[per, dtype, N, nl, name] = (
                            err / LIMITS[dtype] if np.isfinite(err)
                            else np.inf)
                        continue
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
    mode = "early" if args.early else "late"
    errs = errors(load(build(mode, early=args.early)))
    rows_lib = load(build(f"{mode}_rows", early=args.early, rows=True),
                    rows=True)
    for world, cases in ROWS_CASES.items():
        errs.update({(*k[:-1], f"{k[-1]} rows x{world}"): e for k, e in
                     errors(rows_lib, cases, world=world).items()})
    for (per, dtype, N, nl, name), e in errs.items():
        print(f"{'periodic' if per else 'walled'} {dtype} N={N} nl={nl} "
              f"{name}: {e:.3e} of the limit{'' if e <= 1 else '  WRONG'}")
    worst = max(errs.values())
    print(f"worst: {worst:.3e} of the limit")
    return 0 if worst <= 1 else 1


if __name__ == "__main__":
    sys.exit(main())
