#!/usr/bin/env python3
"""Time design variants of the multigrid relaxation (K3) and residual (K4)
kernels on a CUDA card.

    python3 tools/k3_variants.py

Each variant is msom_tpu_torch/csrc/mg_sweep.cu or mg_residual.cu with a
few lines replaced (SWEEP and RESIDUAL below), built with the port's nvcc
flags into build/k3_variants/ (all builds started together, by
tools/k1_variants.py's `build`) and launched through the port's wrappers
(`fused_mg.relax`, `fused_mg.residual_norm`) on chip_smoke.py's random
levels (`mg_level`), in turns over two rounds, with CUDA events; each line
gives the lesser of the two times, its share of the byte bound and the
error against the plain version.

K3: "kmax2" and "kmax8" other sweeps a launch (kmax8 with a 224 KB ring:
one block an SM), "w64" 64-column strips at nl = 4, "rows64" and "rows256"
strips of a fixed height in place of the launch rule's, "depth2" a ring of
LAG (KMAX - 1) + 6 rows (rows issued two steps ahead, the first design),
"copies" element copies, "loads_only" the march without the relaxation
(wrong values on purpose: the copies, barriers and stores alone). The
relaxation of 4 sweeps (one launch) and of 7 (the mg path's nrelax) at
2048^2 x 4 and 2048^2 x 1 f32, and four one-sweep launches; then the
device time (profiler) of a 7-sweep relaxation on every level of the
2048^2 x 4 hierarchy for the shipped kernel, "whole32" (the whole form
only up to n = 32) and "kmax2", against the bound. TMA was not tried:
"loads_only" and "depth2" show that the copies are not what bounds the
march.

K4: "ty32" 32-row tiles at every nl, "row_march" K1's row march
(tools/k4_row_march.cu: a ring of a's and b's rows fed by cp.async, one
barrier a row, 16-byte accesses, a warp a layer), at 2048^2 x 4 and x 1
f32, each with its single launch, back to back (CUDA events: at nl = 1 the
wrapper's host time shows) and as the profiler's device time. Prints the
card's name and power limit last.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import k1_variants  # noqa: E402
from msom_tpu_torch.solvers import fused_mg  # noqa: E402

OUT = ROOT / "build" / "k3_variants"
KMAX = ("constexpr int KMAX = 4;", "constexpr int KMAX = {};")
RING = ("constexpr int RING_BYTES = 96 * 1024;",
        "constexpr int RING_BYTES = {} * 1024;")
ROWS = ("  p.rows = strip_rows<T, NL>(p.n, WAVE_SMS * per_sm);",
        "  p.rows = {};")
SWEEP = {
    "shipped": [],
    "kmax2": [(KMAX[0], KMAX[1].format(2))],
    "kmax8": [(KMAX[0], KMAX[1].format(8)), (RING[0], RING[1].format(224))],
    "w64": [("static constexpr int W = COL <= 16 ? 128 : (COL <= 32 ? 64 "
             ": 32);", "static constexpr int W = COL <= 32 ? 64 : 32;")],
    "rows64": [(ROWS[0], ROWS[1].format(64))],
    "rows256": [(ROWS[0], ROWS[1].format(256))],
    "depth2": [("FIT < RMIN ? RMIN : (FIT < RING_MAX ? FIT : RING_MAX);",
                "RMIN;")],
    "copies": [("  p.vec = n % V == 0", "  p.vec = false && n % V == 0")],
    "loads_only": [("      if (s < k && r >= max(0, y0 - reach)",
                    "      if (s < k && n < 0 && r >= max(0, y0 - reach)")],
    "whole32": [("constexpr int WHOLE_N = 64;", "constexpr int WHOLE_N = 32;")],
}
RESIDUAL = {
    "shipped": [],
    "ty32": [("static constexpr int TY = NL == 1 ? 128 : (NL == 2 ? 64 : "
              "32);", "static constexpr int TY = 32;")],
}
# K4 as K1's row march (its own source, same C entries)
ROW_MARCH = "tools/k4_row_march.cu"


def use(sweep=None, residual=None):
    """Route the wrappers to a variant's library."""
    if sweep is not None:
        fused_mg._sweep_lib = lambda: sweep
    if residual is not None:
        fused_mg._residual_lib = lambda: residual


def main():
    if not torch.cuda.is_available():
        print("k3_variants: no CUDA device", file=sys.stderr)
        return 1
    sweeps = {name: k1_variants.bound(lib, _Sweep)
              for name, lib in k1_variants.build(
                  fused_mg.SWEEP_SOURCE, SWEEP, OUT / "sweep").items()}
    resids = {name: k1_variants.bound(lib, _Residual)
              for name, lib in k1_variants.build(
                  fused_mg.RESIDUAL_SOURCE, RESIDUAL,
                  OUT / "residual").items()}
    resids.update({name: k1_variants.bound(lib, _Residual)
                   for name, lib in k1_variants.build(
                       ROW_MARCH, {"row_march": []},
                       OUT / "row_march").items()})
    rng = np.random.default_rng(0)
    for nl in (4, 1):
        n = 2048
        lvl, idh0, idh1 = cs.mg_level(nl, n, "float32", False, rng)
        da = torch.randn((nl, n, n), device="cuda")
        res = torch.randn((nl, n, n), device="cuda")
        kw = dict(d2=lvl.delta ** 2, sign_x=-1.0, sign_y=-1.0)
        rkw = dict(delta=lvl.delta, idh0=idh0, idh1=idh1, sign_x=-1.0,
                   sign_y=-1.0)
        want = {k: fused_mg.relax_reference(da, res, lvl.sw, nrelax=k, **kw)
                for k in (4, 7)}
        r_want, m_want = fused_mg.residual_norm_reference(da, res, lvl.rp,
                                                          **rkw)
        bound = cs.roofline(*fused_mg.sweep_bound_work(nl, n, 4), 4)[0]
        times = {}
        for _ in range(2):
            for name, lib in sweeps.items():
                use(sweep=lib)
                for k in (4, 7):
                    def run(k=k):
                        return fused_mg.relax(da, res, lvl.sw, nrelax=k,
                                              **kw)
                    err = ((run() - want[k]).abs().max()
                           / want[k].abs().max()).item()
                    times.setdefault((name, k), [err]).append(
                        cs.cuda_ms(run, 30))

                def four():
                    x = da
                    for _ in range(4):
                        x = fused_mg.rb_line_sweep(x, res, lvl.sw, **kw)
                    return x
                if name == "shipped":
                    times.setdefault(("one-sweep x4", 4), [
                        ((four() - want[4]).abs().max()
                         / want[4].abs().max()).item()]).append(
                        cs.cuda_ms(four, 30))
        for (name, k), (err, *t) in times.items():
            print(f"K3 {n}^2 x {nl} f32 {name} nrelax {k}: {min(t):.4f} ms "
                  f"(rounds {', '.join(f'{x:.4f}' for x in t)}), "
                  f"{bound / min(t):.3f} of the byte bound {bound:.4f} ms "
                  f"a launch, error {err:.2e} of max|da|", flush=True)
        rbound = cs.roofline(*fused_mg.residual_bound_work(
            nl, n, 4, lvl.rp.s is not None, False), 4)[0]
        rtimes = {}
        for _ in range(2):
            for name, lib in resids.items():
                use(residual=lib)

                def run():
                    return fused_mg.residual_norm(da, res, lvl.rp, **rkw)
                r, m = run()
                err = max(((r - r_want).abs().max()
                           / r_want.abs().max()).item(),
                          abs(m.item() - m_want.item()) / m_want.item())
                rtimes.setdefault(name, [err]).append(
                    (cs.cuda_ms(run, 30), cs.device_ms(run)))
        for name, (err, *t) in rtimes.items():
            dev = min(d for _, d in t)
            print(f"K4 {n}^2 x {nl} f32 {name}: {min(e for e, _ in t):.4f} "
                  f"ms back to back, {dev:.4f} device ms (profiler; rounds "
                  f"{', '.join(f'{e:.4f}/{d:.4f}' for e, d in t)}), "
                  f"{rbound / dev:.3f} of the byte bound {rbound:.4f} ms, "
                  f"error {err:.2e}", flush=True)
        use(residual=resids["shipped"])
        del da, res, want, r_want
        torch.cuda.empty_cache()
    # the hierarchy of the mg path: a 7-sweep relaxation a level
    nl = 4
    for name in ("shipped", "whole32", "kmax2"):
        use(sweep=sweeps[name])
        rows, total, total_b = [], 0.0, 0.0
        n = 2048
        while n >= 2:
            lvl, _, _ = cs.mg_level(nl, n, "float32", False, rng)
            z = torch.randn((nl, n, n), device="cuda")
            kw = dict(d2=lvl.delta ** 2, sign_x=-1.0, sign_y=-1.0)
            launches0 = fused_mg.sweep_launches
            fused_mg.relax(z, z, lvl.sw, nrelax=7, **kw)
            launches = fused_mg.sweep_launches - launches0
            dev = cs.device_ms(
                lambda: fused_mg.relax(z, z, lvl.sw, nrelax=7, **kw))
            b = launches * cs.roofline(
                *fused_mg.sweep_bound_work(nl, n, 4), 4)[0]
            rows.append(f"n={n}: {launches} launches, {dev:.4f} ms "
                        f"({dev / b:.1f}x the bound)")
            total += dev
            total_b += b
            n //= 2
        print(f"K3 {name} relaxation of 7 sweeps by level, device ms: "
              + "; ".join(rows) + f"; in all {total:.4f} ms against "
              f"{total_b:.4f}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    return 0


class _Sweep:
    """fused_mg's sweep-library declarations, for k1_variants.bound."""
    _lib = fused_mg._sweep_lib


class _Residual:
    _lib = fused_mg._residual_lib


if __name__ == "__main__":
    sys.exit(main())
