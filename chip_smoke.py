#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (msom_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout; imports nothing of
JAX or msom_tpu. Phases, in order; any failure exits non-zero:

1. build every kernel from msom_tpu_torch/csrc (one nvcc per source, all
   started together);
2. hold each kernel against its plain PyTorch version on the card, in f32
   and f64: the fused RHS (K1) uncoupled, with each coupling option alone
   (pg; pg + flsrv; topo; qforc; energy_conserv; sbc = 1) and with all of
   them, and the fused tracer tendency (K2) with 1 and 2 tracers, with and
   without a relaxation field, each at N = 256 with nl = 1, 3, 4, at
   N = 100 (partial tiles) and at 2048^2 x 4; the fused spectral solve (K7)
   at N = 128, 512, 1024 with nl = 1, 4;
3. hold the whole step on the card against the port on the CPU, 128^2 x 3
   in f64 over 20 steps from one numpy IC: the Verron double gyre, and the
   coupled configuration (psipg, topo, qforc, 2 tracers);
4. run the uncoupled main path: bench.py's 2048^2 x 4 f32 spectral
   configuration from a numpy-seeded noise IC, 20 warm-up steps, 40 steps
   timed with CUDA events, counting K1's launches; time K1 alone, its plain
   version and its roofline bound on the final state; profile four steps;
5. run the coupled path: bench.py's coupled configuration at 2048^2 x 4 f32
   (a large-scale streamfunction, bottom topography, two passive tracers),
   the same protocol, counting K1's and K2's launches; time both kernels
   alone against their plain versions and bounds; profile four steps;
6. run the fused-solve path: the uncoupled step at 1024^2 x 4 f32 with
   fused_mm=True (K7), beside the same step with transform="matmul" (the
   cuBLAS chain) and with the default folded DST: 10 warm-up steps each,
   then 20 timed steps of each in turns, three times, the least reported;
   time K7 alone against its plain version (that cuBLAS chain, which is
   also its library yardstick) and its bound.

TF32 is switched off for matmuls and convolutions before anything runs:
1-pass reduced-precision transforms give O(1) solution error at N = 2048.
The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet), for the roofline bound
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {4: 67e12, 8: 34e12}    # FP32 / FP64 outside tensor cores
LIMITS = {4: 1e-4, 8: 1e-11}             # K1, K2 vs plain, of max|out|
K7_LIMITS = {4: 1e-5, 8: 1e-12}          # K7 vs plain, of max|psi_m|
STEP_LIMIT = 1e-10                        # CUDA step vs CPU step, f64
K1_OPTIONS = ("pg", "pg_flsrv", "topo", "qforc", "energy_conserv", "slip",
              "all")
TRACERS = dict(nptr=2, Pe=(1e3, 2e3), ptr_r=(100.0, 0.0))


def verron(QGConfig, N, **kw):
    """The Verron (1992) double gyre at 3 layers (tests/test_lockstep.py)."""
    base = dict(N=N, nl=3, L0=80, Rom=0.025, Ekb=0.002, tau0=1e-4, Re4=1563,
                beta=0.5, Fr=(0.0023669, 0.0076173), dh=(0.06, 0.14, 0.8),
                DT=5e-2, tend=500., dtout=1., CFL=0.6, dtype="float64",
                solver="spectral")
    base.update(kw)
    return QGConfig(**base).validate()


def bench_config(QGConfig, N, nl, dtype, **kw):
    """bench.py's 4-layer Verron variant scaled to N (bench.py:63-68)."""
    return QGConfig(N=N, nl=nl, L0=80, Rom=0.025, Ekb=0.002, tau0=1e-4,
                    Re4=1563 * (N / 256) ** 3, beta=0.5,
                    Fr=tuple([0.003] * (nl - 1)), dh=tuple([1.0 / nl] * nl),
                    DT=5e-2, tend=1e9, dtout=1e9, CFL=0.6, dtype=dtype,
                    solver="spectral", **kw).validate()


def coupled_fields(cfg, noise=0.0, seed=0):
    """bench.py's coupling inputs (bench.py:69-74): a gyre-shaped large-scale
    streamfunction and a sine topography; `noise` adds a rough part (and a
    3-D forcing) so that a kernel check exercises every stencil point."""
    N, nl = cfg.N, cfg.nl
    y = (np.arange(N) + 0.5) * cfg.delta
    gyre = np.sin(np.pi * y / cfg.L0)
    fields = dict(
        psipg=0.01 * gyre[None, :, None] * np.ones((nl, N, N)),
        topo=0.05 * np.outer(gyre, np.sin(2 * np.pi * y / cfg.L0)))
    if noise:
        rng = np.random.default_rng(seed)
        fields["psipg"] = fields["psipg"] \
            + noise * rng.uniform(-1, 1, (nl, N, N))
        fields["topo"] = fields["topo"] \
            + 10 * noise * rng.uniform(-1, 1, (N, N))
        # of the size of dq itself, so that a fault in it shows in f32 too
        fields["qforc"] = 1e3 * noise * rng.uniform(-1, 1, (nl, N, N))
    return fields


def k1_variant(cfg, const, name):
    """(cfg, const) of one K1 option set, cut out of constants built with
    every coupling field and flsrv = 1."""
    no_pg = dict(pp_pad=None, pp=None, zetap_pad=None, umax_pp=None)
    no_topo = dict(topo_pad=None, topo=None, iro=None)
    off = {"uncoupled": {**no_pg, **no_topo, "qforc": None},
           "pg": {**no_topo, "zetap_pad": None, "qforc": None},
           "pg_flsrv": {**no_topo, "qforc": None},
           "topo": {**no_pg, "qforc": None},
           "qforc": {**no_pg, **no_topo},
           "energy_conserv": {**no_pg, **no_topo, "qforc": None},
           "slip": {**no_pg, **no_topo, "qforc": None},
           "all": {}}[name]
    kw = dict(flsrv=int(name in ("pg_flsrv", "all")),
              energy_conserv=name in ("energy_conserv", "all"),
              sbc=1.0 if name in ("slip", "all") else 0.0)
    return (dataclasses.replace(cfg, **kw).validate(),
            dataclasses.replace(const, **off))


def cuda_ms(fn, n):
    """Mean milliseconds of fn() over n calls, timed with CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def kernel_times(kernel, plain, n_kernel=50, n_plain=10):
    """(kernel ms, plain ms), in turns kernel, plain, kernel after a
    warm-up; the kernel's time is the lesser of its two."""
    for _ in range(3):
        kernel()
        plain()
    k1 = cuda_ms(kernel, n_kernel)
    p = cuda_ms(plain, n_plain)
    k2 = cuda_ms(kernel, n_kernel)
    return min(k1, k2), p


def roofline(nbytes, nops, itemsize):
    """(bound ms, what bounds it, bytes ms, operations ms)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S[itemsize] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", t_bytes, t_ops)


def kernel_profile(label, step_fn, steps, ms_step):
    """Device time by kernel over a profiled window of `steps` steps, and
    the share of the step the device is busy (against the unprofiled
    ms/step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step_fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us / 1e3 / steps, e.count / steps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows or busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    print(f"profile {label}: device busy {busy:.4f} ms/step of "
          f"{ms_step:.4f} (idle share {1 - busy / ms_step:.4f}), "
          f"{len(rows)} kernels, {sum(r[1] for r in rows):.1f} launches/step")
    for ms, n, name in rows[:14]:
        print(f"  {ms:9.4f} ms/step {n:6.1f} launches/step  {name[:90]}")


def timed_steps(step, state, const, steps):
    """Time `steps` steps with CUDA events: (state, last diag, ms/step)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        state, diag = step(state, const, 1e18)
    end.record()
    torch.cuda.synchronize()
    return state, diag, start.elapsed_time(end) / steps


def state_ok(state, diag, shape):
    """Finite fields of the expected shape, a finite KE and dt > 0."""
    import torch
    fields = [state.q, state.psi] + ([state.tracers]
                                     if state.tracers is not None else [])
    return (all(bool(torch.isfinite(f).all()) for f in fields)
            and np.isfinite(diag.ke.item()) and diag.dt.item() > 0
            and tuple(state.q.shape) == shape)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from msom_tpu_torch import _build
    from msom_tpu_torch.models import fused_rhs, fused_tracer, qg
    from msom_tpu_torch.params import QGConfig
    from msom_tpu_torch.solvers import fused_spectral, spectral

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t_start = time.perf_counter()

    def dev(a, dtype):
        return torch.as_tensor(a, dtype=getattr(torch, dtype)).cuda()

    # 1. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(sorted(logs))})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # 2. each kernel against its plain version on the card
    sizes = [(256, 1), (256, 3), (256, 4), (100, 3), (2048, 4)]
    main_err = {}
    ok = True
    for dtype in ("float64", "float32"):
        isz = 8 if dtype == "float64" else 4
        lim = LIMITS[isz]
        for N, nl in sizes:
            # the uncoupled kernel with and without Re, then each option set
            Re = 0.0 if N in (100, 2048) else 1000.0
            cfg = bench_config(QGConfig, N, nl, dtype, Re=Re, Eks=0.001,
                               flsrv=1, **TRACERS)
            rng = np.random.default_rng(N + nl)
            full = qg.build_constants(cfg, device="cuda",
                                      **coupled_fields(cfg, 1e-3, N + nl))
            psi = dev(1e-3 * rng.uniform(-1, 1, (nl, N, N)), dtype)
            q = qg.comp_q(cfg, full, psi)
            for name in ("uncoupled",) + K1_OPTIONS:
                vcfg, vconst = k1_variant(cfg, full, name)
                qin = q if vcfg.energy_conserv else None
                dq_k, um_k = fused_rhs.rhs_fused(vcfg, vconst, psi, qin)
                dq_r, um_r = fused_rhs.rhs_fused_reference(vcfg, vconst, psi,
                                                           qin)
                torch.cuda.synchronize()
                abs_err = (dq_k - dq_r).abs().max().item()
                rel = abs_err / dq_r.abs().max().item()
                rel_u = ((um_k - um_r).abs() / um_r).max().item()
                good = rel <= lim and rel_u <= lim
                ok &= good
                print(f"K1 check {dtype} N={N} nl={nl} Re={Re:g} {name}: "
                      f"max|d dq|/max|dq| = {rel:.3e}, "
                      f"max|d umax|/umax = {rel_u:.3e} (limit {lim:g}) "
                      f"{'ok' if good else 'FAIL'}")
                if dtype == "float32" and (N, nl) == (2048, 4):
                    main_err["fused_rhs", name] = abs_err
                del dq_k, dq_r
            # K2: 1 and 2 tracers, with and without a relaxation field
            for nptr in (1, 2):
                tcfg = dataclasses.replace(cfg, nptr=nptr, Pe=cfg.Pe[:nptr],
                                           ptr_r=cfg.ptr_r[:nptr]).validate()
                tr = dev(1e-3 * rng.uniform(-1, 1, (nl, nptr, N, N)), dtype)
                relax = dev(1e-3 * rng.uniform(-1, 1, (nl, nptr, N, N)),
                            dtype)
                for with_relax in (False, True):
                    tconst = dataclasses.replace(
                        full, ptr_relax=relax if with_relax else None)
                    d_k = fused_tracer.tracer_fused(tcfg, tconst, psi, tr)
                    d_r = fused_tracer.tracer_fused_reference(tcfg, tconst,
                                                              psi, tr)
                    torch.cuda.synchronize()
                    abs_err = (d_k - d_r).abs().max().item()
                    rel = abs_err / d_r.abs().max().item()
                    good = rel <= lim and d_k.shape == tr.shape
                    ok &= good
                    print(f"K2 check {dtype} N={N} nl={nl} nptr={nptr} "
                          f"relax={with_relax}: max|d dtr|/max|dtr| = "
                          f"{rel:.3e} (limit {lim:g}) "
                          f"{'ok' if good else 'FAIL'}")
                    if (dtype == "float32" and (N, nl, nptr) == (2048, 4, 2)
                            and not with_relax):
                        main_err["fused_tracer"] = abs_err
                    del d_k, d_r
                del tr, relax
            del full, psi, q
            torch.cuda.empty_cache()
        # K7 against the cuBLAS chain
        for N in (128, 512, 1024):
            for nl in (1, 4):
                spec = spectral.build_spectral(
                    nl=nl, N=N, L0=80.0, dh=np.full(nl, 1.0 / nl),
                    s_profile=np.full(nl - 1, (0.003 / 0.025) ** 2),
                    dtype=getattr(torch, dtype), transform="matmul",
                    fused_mm=True, device="cuda")
                qm = dev(np.random.default_rng(N + nl).standard_normal(
                    (nl, N, N)), dtype)
                before = fused_spectral.launches
                pm_k = fused_spectral.fused_mm_solve(spec.S, spec.inv_den, qm)
                pm_r = spectral._mm_solve(spec.S, spec.inv_den, qm)
                torch.cuda.synchronize()
                abs_err = (pm_k - pm_r).abs().max().item()
                scale = pm_r.abs().max().item()
                rel = abs_err / scale
                good = (rel <= K7_LIMITS[isz]
                        and fused_spectral.launches == before + 4)
                ok &= good
                extra = ""
                if dtype == "float32":
                    # both against the f64 chain, to tell the two f32
                    # roundings apart (information, not a check)
                    pm_d = spectral._mm_solve(spec.S.double(),
                                              spec.inv_den.double(),
                                              qm.double())
                    extra = (f", against the f64 chain: kernel "
                             f"{(pm_k - pm_d).abs().max().item() / scale:.3e}"
                             f", cuBLAS "
                             f"{(pm_r - pm_d).abs().max().item() / scale:.3e}")
                    del pm_d
                print(f"K7 check {dtype} N={N} nl={nl}: max|d psi_m|/"
                      f"max|psi_m| = {rel:.3e} (limit {K7_LIMITS[isz]:g})"
                      f"{extra} {'ok' if good else 'FAIL'}")
                if dtype == "float32" and (N, nl) == (1024, 4):
                    main_err["fused_spectral"] = abs_err
                del spec, qm, pm_k, pm_r
    if not ok:
        return 2
    print(f"kernel checks done at {time.perf_counter() - t_start:.0f} s")

    # 3. whole step, CUDA against CPU, f64: uncoupled and coupled
    for label, cfg in (("uncoupled", verron(QGConfig, 128)),
                       ("coupled", verron(QGConfig, 128, **TRACERS))):
        rng = np.random.default_rng(42)
        psi0 = 1e-3 * rng.uniform(-1, 1, (cfg.nl, cfg.N, cfg.N))
        fields, tr0 = {}, None
        if label == "coupled":
            fields = coupled_fields(cfg)
            fields["qforc"] = 1e-5 * rng.standard_normal(psi0.shape)
            tr0 = 1e-3 * rng.uniform(-1, 1, (cfg.nl, cfg.nptr, cfg.N, cfg.N))
        step = qg.make_step(cfg)
        states = {}
        for where in ("cpu", "cuda"):
            const = qg.build_constants(cfg, device=where, **fields)
            state = qg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
            for _ in range(20):
                state, diag = step(state, const, 1e9)
            states[where] = state
        names = ["q", "psi"] + (["tracers"] if tr0 is not None else [])
        rels = {}
        for name in names:
            want = getattr(states["cpu"], name)
            rels[name] = ((getattr(states["cuda"], name).cpu() - want)
                          .abs().max() / want.abs().max()).item()
        good = all(r <= STEP_LIMIT for r in rels.values())
        print(f"step check {label} 128^2 x 3 f64, 20 steps cuda vs cpu: "
              + ", ".join(f"rel {k} = {v:.3e}" for k, v in rels.items())
              + f" (limit {STEP_LIMIT:g}) {'ok' if good else 'FAIL'}")
        if not good:
            return 3

    # 4 and 5. the uncoupled main path and the coupled path at full size
    N, nl, warm, steps = 2048, 4, 20, 40
    shape = (nl, N, N)
    rows = []
    for label in ("uncoupled", "coupled"):
        coupled = label == "coupled"
        cfg = bench_config(QGConfig, N, nl, "float32",
                           **(TRACERS if coupled else {}))
        t0 = time.perf_counter()
        const = qg.build_constants(
            cfg, device="cuda", **(coupled_fields(cfg) if coupled else {}))
        rng = np.random.default_rng(0)
        psi0 = 1e-3 * rng.uniform(-1, 1, shape)
        tr0 = 1e-3 * rng.uniform(-1, 1, (nl, cfg.nptr, N, N)) \
            if coupled else None
        state = qg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
        step = qg.make_step(cfg)
        torch.cuda.synchronize()
        print(f"{label} path set-up: {time.perf_counter() - t0:.1f} s")
        for _ in range(warm):
            state, diag = step(state, const, 1e18)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_rhs.launches = fused_tracer.launches = 0
        fused_spectral.launches = 0
        state, diag, ms_step = timed_steps(step, state, const, steps)
        n_rhs, n_tr = fused_rhs.launches, fused_tracer.launches
        want_tr = 2 * steps if coupled else 0
        finite = state_ok(state, diag, shape)
        print(f"{label} path {N}^2 x {nl} f32 spectral: {ms_step:.4f} "
              f"ms/step, {N * N * nl / (ms_step * 1e-3):.4e} grid-points/s, "
              f"fused_rhs launches {n_rhs} (expected {2 * steps}), "
              f"fused_tracer launches {n_tr} (expected {want_tr}), "
              f"ke {diag.ke.item():.6e}, dt {diag.dt.item():.6e}, "
              f"t {state.t.item():.6e}, finite {finite}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if n_rhs != 2 * steps or n_tr != want_tr or not finite \
                or fused_spectral.launches != 0:
            return 4

        psi = state.psi.contiguous()
        k_ms, p_ms = kernel_times(
            lambda: fused_rhs.rhs_fused(cfg, const, psi),
            lambda: fused_rhs.rhs_fused_reference(cfg, const, psi))
        nbytes, nops = fused_rhs.bound_work(cfg, const, 4)
        bound, by, t_b, t_o = roofline(nbytes, nops, 4)
        print(f"K1 {label} at {N}^2 x {nl} f32: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, bound {bound:.4f} ms by {by} (bytes "
              f"{nbytes} -> {t_b:.4f} ms, operations {nops} -> {t_o:.4f} "
              f"ms), library_ms null")
        rows.append({
            "name": "fused_rhs", "path": f"{label} {N}^2 x {nl} f32",
            "route": "cuda", "source": fused_rhs.SOURCE,
            "replaces": "msom_tpu/models/pallas_rhs.py:441",
            "launches": n_rhs,
            # the coupled path's K1 runs the pg and topo options: the
            # larger of the two checks' errors at these shapes
            "max_abs_err": max(main_err["fused_rhs", "pg"],
                               main_err["fused_rhs", "topo"]) if coupled
            else main_err["fused_rhs", "uncoupled"],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None})
        if coupled:
            tr = state.tracers
            k_ms, p_ms = kernel_times(
                lambda: fused_tracer.tracer_fused(cfg, const, psi, tr),
                lambda: fused_tracer.tracer_fused_reference(cfg, const, psi,
                                                            tr))
            nbytes, nops = fused_tracer.bound_work(cfg, const, 4)
            bound, by, t_b, t_o = roofline(nbytes, nops, 4)
            print(f"K2 at {N}^2 x {nl} x {cfg.nptr} tracers f32: kernel "
                  f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound:.4f} ms "
                  f"by {by} (bytes {nbytes} -> {t_b:.4f} ms, operations "
                  f"{nops} -> {t_o:.4f} ms), library_ms null")
            rows.append({
                "name": "fused_tracer", "path": f"{label} {N}^2 x {nl} f32",
                "route": "cuda", "source": fused_tracer.SOURCE,
                "replaces": "msom_tpu/models/pallas_rhs.py:778",
                "launches": n_tr, "max_abs_err": main_err["fused_tracer"],
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                "bound_by": by, "library_ms": None})
            del tr

        # where a step's device time goes
        box = [state]

        def one_step():
            box[0], _ = step(box[0], const, 1e18)

        kernel_profile(label, one_step, 4, ms_step)
        del const, state, psi, box
        torch.cuda.empty_cache()
    print(f"full-size paths done at {time.perf_counter() - t_start:.0f} s")

    # 6. the fused-solve path: 1024^2 x 4, K7 beside cuBLAS and the fold
    N, nl, warm, steps = 1024, 4, 10, 20
    shape = (nl, N, N)
    psi0 = 1e-3 * np.random.default_rng(0).uniform(-1, 1, shape)
    # the device work of a step is short at this size, so the host shows in
    # ms/step: the three variants are timed in turns, `rounds` times each
    rounds = 3
    runs = {}
    for label, kw, build_kw in (
            ("fused_mm (K7)", {}, dict(fused_mm=True)),
            ("transform=matmul (cuBLAS chain)", dict(transform="matmul"), {}),
            ("default (folded DST)", {}, {})):
        cfg = bench_config(QGConfig, N, nl, "float32", **kw)
        const = qg.build_constants(cfg, device="cuda", **build_kw)
        state = qg.init_state(cfg, const, psi0=psi0)
        step = qg.make_step(cfg)
        for _ in range(warm):
            state, diag = step(state, const, 1e18)
        runs[label] = dict(const=const, state=state, step=step, ms=[],
                           want=8 * steps if build_kw else 0)
    torch.cuda.synchronize()
    for _ in range(rounds):
        for label, run in runs.items():
            fused_rhs.launches = fused_tracer.launches = 0
            fused_spectral.launches = 0
            run["state"], run["diag"], ms_step = timed_steps(
                run["step"], run["state"], run["const"], steps)
            run["ms"].append(ms_step)
            run["n_k7"] = fused_spectral.launches
            if run["n_k7"] != run["want"] \
                    or fused_rhs.launches != 2 * steps:
                print(f"{label}: fused_spectral launches {run['n_k7']} "
                      f"(expected {run['want']}), fused_rhs launches "
                      f"{fused_rhs.launches} (expected {2 * steps})")
                return 5
    for label, run in runs.items():
        diag, ms_step = run["diag"], min(run["ms"])
        finite = state_ok(run["state"], diag, shape)
        print(f"{N}^2 x {nl} f32 step, {label}: {ms_step:.4f} ms/step (the "
              f"least of {', '.join(f'{m:.4f}' for m in run['ms'])}), "
              f"{N * N * nl / (ms_step * 1e-3):.4e} grid-points/s, "
              f"fused_spectral launches {run['n_k7']} a round (expected "
              f"{run['want']}), fused_rhs launches {2 * steps}, "
              f"ke {diag.ke.item():.6e}, dt {diag.dt.item():.6e}, "
              f"finite {finite}")
        if not finite:
            return 5
    k7_run, mm_run = list(runs.values())[:2]
    k7_launches, k7_state, k7_const = (k7_run["n_k7"], k7_run["state"],
                                       k7_run["const"])
    a, b = k7_run["state"].psi, mm_run["state"].psi
    rel = ((a - b).abs().max() / b.abs().max()).item()
    print(f"K7 path against the cuBLAS path after {warm + rounds * steps} "
          f"steps: "
          f"max|d psi|/max|psi| = {rel:.3e} (limit 1e-3)")
    if not rel <= 1e-3:
        return 5
    spec = k7_const.spec
    qm = torch.einsum("ml,lyx->myx", spec.l2m, k7_state.q).contiguous()
    k_ms, p_ms = kernel_times(
        lambda: fused_spectral.fused_mm_solve(spec.S, spec.inv_den, qm),
        lambda: spectral._mm_solve(spec.S, spec.inv_den, qm), 20, 20)
    nbytes, nops = fused_spectral.bound_work(N, nl, 4)
    bound, by, t_b, t_o = roofline(nbytes, nops, 4)
    print(f"K7 at {N}^2 x {nl} f32: kernel {k_ms:.4f} ms a solve (4 "
          f"launches), plain = library (cuBLAS chain, TF32 off) {p_ms:.4f} "
          f"ms, bound {bound:.4f} ms by {by} on the FP32 pipe (bytes "
          f"{nbytes} -> {t_b:.4f} ms, operations {nops} -> {t_o:.4f} ms)")
    rows.append({
        "name": "fused_spectral", "path": f"fused_mm {N}^2 x {nl} f32",
        "route": "cuda", "source": fused_spectral.SOURCE,
        "replaces": "msom_tpu/solvers/pallas_spectral.py:82",
        "launches": k7_launches, "max_abs_err": main_err["fused_spectral"],
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": p_ms})

    print(f"total {time.perf_counter() - t_start:.0f} s")
    print('kernels: ["fused_rhs", "fused_tracer", "fused_spectral"]')
    print(json.dumps({"kernels": rows}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
