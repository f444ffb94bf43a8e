"""Run loops and events of the msqg and mspg models (the port of
`msom_tpu.driver`), and their command line, the `./qg.e params.in` and
`./pg.e params.in` equivalent:

    python -m msom_tpu_torch.driver --config params.in [--model qg|pg]
        [--steps N] [--deck DIR] [--outdir DIR] [--no-output] [--cpu]
    torchrun --nproc_per_node=W -m msom_tpu_torch.driver --config
        params.in --sharded [--sharded-mode auto|rows|gspmd]

Basilisk's event system (run()/event blocks) becomes an explicit host loop
around the step: output every dtout (and at t = 0), the wavelet filter
every dtflt, and `dtnext` inside the step makes steps land exactly on the
event times. The loop reads the model time and the KE back to the host
once a step (for the events, the NaN guards and the log); everything else
stays on the state's device. The mspg loop (`run_pg`) is the same with its
own events: the running means every 10 steps, the state dump at t = 0 and
every dtout (`PGOutputWriter`).

The sharded msqg run (`run_qg(sharded=True|"auto"|"rows"|"gspmd")`,
`--sharded`) steps the ranks of a torch.distributed group
(parallel/step.py): the rows step, or the general-mesh step that is the
port's form of the JAX package's GSPMD run, routed as the JAX driver
routes them; the events gather the whole state (the filter runs on it on
every rank, the writers on the master only). The sharded mspg run
(`run_pg(sharded=True)`, `--model pg --sharded`) steps each rank's rows
(parallel/pg_step.py) and gathers the running means for the output.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Callable

import numpy as np
import torch

from msom_tpu_torch.io.bas import write_bas
from msom_tpu_torch.io.deck import load_pg_deck, load_qg_deck
from msom_tpu_torch.models import mspg, qg, qg_energy
from msom_tpu_torch.ops.wavelet import wavelet_filter_step
from msom_tpu_torch.parallel import dist
from msom_tpu_torch.parallel.pg_step import make_pg_step_sharded
from msom_tpu_torch.parallel.step import make_qg_step_sharded
from msom_tpu_torch.params import (PGConfig, QGConfig, load_pg_config,
                                   load_qg_config)


@dataclasses.dataclass
class RunHooks:
    """Callbacks fired by the driver on the host."""
    on_log: Callable | None = None      # (i, dt, t, ke) every step
    on_output: Callable | None = None   # (state, t) every dtout
    on_filter: Callable | None = None   # (state, t) every dtflt


def _next_event(t, cadence, eps=1e-10):
    """The first multiple of `cadence` strictly after t (within eps)."""
    if cadence <= 0:
        return np.inf
    k = np.floor((t + eps) / cadence) + 1
    return k * cadence


def _time_eps(t: float, dtype: torch.dtype) -> float:
    """How close the model time t must come to an event time for the event
    to fire: 1e-10 (the JAX driver's), or 16 units in the last place of t
    where the model time's type is coarser (float32). A float32 t cannot
    reach an event time such as 0.9 within 1e-10, and would then take
    steps of dt = 0 forever."""
    return max(1e-10, 16 * torch.finfo(dtype).eps * max(1.0, abs(t)))


def run_qg(cfg: QGConfig, *, const=None, state=None, hooks: RunHooks = None,
           max_steps: int | None = None, log_every: int = 1,
           generator: torch.Generator | None = None, seed: int = 0,
           sharded=False, mesh=None, device="cuda"):
    """Integrate the msqg model to cfg.tend; returns (state, energy), the
    energy accumulator None when ediag = -1; with `sharded`
    (state, energy, mode).

    The reference driver loop (msqg/qg.c): the KE heartbeat each step
    (writestdout), the output event at t = 0 and every dtout (the energy
    window flushed through `hooks.on_output.write_energy` where the hook
    has one, then reset), the filter event every dtflt (`filter_de` first
    when ediag > -1, then `wavelet_filter_step`), and with ediag > -1 the
    energy budget summed every step (comp_diag, qg_energy.h:286-288).
    `const` and `state` default to `build_constants(cfg, device=device)`
    and its `init_state`. A stochastic run draws from `generator` (on the
    state's device), else from one made here and seeded with `seed`.

    `sharded` (True, "auto", "rows" or "gspmd") runs parallel/step.py's
    sharded step on the ranks of the running process group (world size 1
    without one; `dist.init` starts it), each rank calling run_qg with the
    whole `const` and `state`, and returns the mode taken, the string the
    JAX package records in run_qg.sharded_mode (msom_tpu/driver.py:
    193-240): "auto" takes "rows" where the rows step takes the
    configuration (step.rows_refusal) and else "gspmd"; "rows" on another
    configuration raises ValueError, as the JAX driver does; "gspmd" runs
    the general-mesh step on `mesh` (my, mx), or on step.choose_mesh's,
    which raises ValueError where no factorization of the world cuts the
    grid. The events gather the whole state on every rank (the step's
    `gather`): the filter and the energy budget run on it on every rank,
    the hooks' writers and the log on the master only. The state returned is the
    whole state, on every rank. A stochastic run draws from a generator of
    each rank's own, seeded from (seed, rank), unless `generator` is
    given."""
    mode = None
    if sharded:
        mode = sharded if isinstance(sharded, str) else "auto"
        if mode not in ("auto", "rows", "gspmd"):
            raise ValueError(f"sharded={mode!r}: use 'auto', 'rows' or "
                             "'gspmd'")
    hooks = hooks or RunHooks()
    if const is None:
        const = qg.build_constants(cfg, device=device)
    if state is None:
        state = qg.init_state(cfg, const)
    if mode is not None:
        rs = make_qg_step_sharded(cfg, device=state.q.device,
                                  generator=generator, seed=seed, mesh=mesh,
                                  mode=mode, const=const)
        mode, const_step, state = rs.mode, rs.shard(const), rs.shard(state)
        step = rs.step
        whole = rs.gather
    else:
        if cfg.stochastic and generator is None:
            generator = torch.Generator(
                device=state.q.device).manual_seed(seed)
        step, const_step = qg.make_step(cfg, generator), const

        def whole(x):
            return x
    if mode is not None and not dist.is_master():
        hooks = RunHooks()          # the writers and the log: master only
    energy = None
    if cfg.ediag > -1:
        energy = qg_energy.init_energy(cfg, device=state.q.device)
    write_energy = getattr(hooks.on_output, "write_energy", None)

    t = float(state.t)
    tend = cfg.tend
    eps = _time_eps(t, state.t.dtype)
    next_out = 0.0  # the output event also fires at t = 0 (qg.c:112)
    next_flt = _next_event(0.0, cfg.dtflt, eps)
    while t < tend - eps:
        if t >= next_out - eps:
            g = whole(state)      # on every rank: a collective when sharded
            if hooks.on_output is not None:
                hooks.on_output(g, t)
            if energy is not None:
                if write_energy is not None:
                    write_energy(energy, int(state.i))
                energy = qg_energy.reset_window(energy)
            next_out = _next_event(t, cfg.dtout, eps)
        if cfg.dtflt > 0 and t >= next_flt - eps:
            g = whole(state)
            if energy is not None:
                energy = qg_energy.filter_de(cfg, const, energy, g.q, g.psi)
            g = wavelet_filter_step(cfg, const, g)
            state = g if mode is None else rs.shard(g)
            if hooks.on_filter is not None:
                hooks.on_filter(g, t)
            next_flt = _next_event(t, cfg.dtflt, eps)

        tnext = min(next_out, next_flt, tend)
        state, diag = step(state, const_step, tnext)
        t = float(state.t)
        i = int(state.i)
        eps = _time_eps(t, state.t.dtype)
        # a CFL or KE NaN reaches t within one step: stop instead of
        # integrating garbage to tend
        if t != t:
            raise FloatingPointError(
                f"non-finite model time after step {i}: blow-up or NaN in "
                "the state (check DT/CFL; resume from the last checkpoint)")
        if energy is not None:
            energy = qg_energy.energy_tend(cfg, const, energy,
                                           whole(state.psi), diag.dt)
        if hooks.on_log is not None and i % log_every == 0:
            ke = float(diag.ke)
            if ke != ke:
                raise FloatingPointError(
                    f"non-finite kinetic energy at step {i} (t={t:g})")
            hooks.on_log(i, float(diag.dt), t, ke)
        if max_steps is not None and i >= max_steps:
            break

    state = whole(state)
    if hooks.on_output is not None and t >= next_out - eps:
        hooks.on_output(state, t)
    if mode is None:
        return state, energy
    return state, energy, mode


def run_pg(cfg: PGConfig, *, const=None, state=None, hooks: RunHooks = None,
           max_steps: int | None = None, sharded=False, device="cuda"):
    """Integrate the mspg model to cfg.tend (the driver loop of
    mspg/pg.c); returns the state. The running means are accumulated
    every 10 steps (comp_output) and reset after each output event; the
    output event (writestate, `hooks.on_output`) fires at t = 0 and every
    dtout. Event times are compared within `_time_eps`. `const` and
    `state` default to `mspg.build_constants(cfg, device=device)` and its
    `init_state`; `hooks.on_log` gets (i, dt, t, 0.0) every step.

    `sharded` runs parallel/pg_step.py's rows step on the ranks of the
    running process group (world size 1 without one), each rank calling
    run_pg with the whole `const` and `state`: the means are accumulated
    on the rows, an output event gathers the state on every rank and the
    hooks run on the master only; the state returned is the whole state,
    on every rank. A grid whose rows do not cut into the ranks raises
    ValueError."""
    hooks = hooks or RunHooks()
    if const is None:
        const = mspg.build_constants(cfg, device=device)
    if state is None:
        state = mspg.init_state(cfg, const)
    t = float(state.t)
    eps = _time_eps(t, state.t.dtype)
    next_out = _next_event(0.0, cfg.dtout, eps)
    if sharded:
        rs = make_pg_step_sharded(cfg)
        step, whole = rs.step, rs.gather
        const, first = rs.shard(const), state
        state = rs.shard(state)
        if not dist.is_master():
            hooks = RunHooks()       # the writers and the log: master only
    else:
        step = mspg.make_step(cfg)
        first = state

        def whole(x):
            return x
    if hooks.on_output is not None:
        hooks.on_output(first, t)   # writestate fires at t = 0 (pg.c:213)

    while t < cfg.tend - eps:
        tnext = min(next_out, cfg.tend)
        state, diag = step(state, const, tnext)
        t = float(state.t)
        i = int(state.i)
        eps = _time_eps(t, state.t.dtype)
        if t != t:
            raise FloatingPointError(
                f"non-finite model time after step {i}: blow-up or NaN in "
                "the state (check DT/CFL)")
        if i % 10 == 0:
            state = mspg.accumulate_means(state)
        if hooks.on_log is not None:
            hooks.on_log(i, float(diag.dt), t, 0.0)
        if t >= next_out - eps:
            g = whole(state)         # on every rank: a collective sharded
            if hooks.on_output is not None:
                hooks.on_output(g, t)
            state = dataclasses.replace(state,
                                        nme=torch.zeros_like(state.nme))
            next_out = _next_event(t, cfg.dtout, eps)
        if max_steps is not None and i >= max_steps:
            break
    return whole(state)


def create_outdir(outdir: str | None, prefix: str = "outdir") -> str:
    """`outdir` (made if missing), or the first free `outdir_%04d/`
    (create_outdir, msqg/qg.h:766-780, qg-node/extra.h:121-135)."""
    if outdir is None:
        for k in range(1, 10000):
            cand = f"{prefix}_{k:04d}"
            try:
                os.makedirs(cand)
                return cand
            except FileExistsError:
                continue
        raise FileExistsError(f"{prefix}_0001 .. {prefix}_9999 all exist")
    os.makedirs(outdir, exist_ok=True)
    return outdir


class OutputWriter:
    """Reference-compatible output: makes `outdir_%04d/` (the next free
    one, or `outdir`), backs up the config and the derived fields, and
    writes the po/qo/pf/ptr snapshots and the energy budget as `.bas` files
    under the reference's names (msqg/qg.c:112-173, create_outdir
    qg.h:766-780, backup_config qg.h:782-835). One process."""

    def __init__(self, cfg: QGConfig, const, outdir=None, params_text=None):
        self.cfg = cfg
        self.const = const
        self.dir = create_outdir(outdir)
        if params_text is not None:
            with open(f"{self.dir}/params.in", "w") as f:
                f.write(params_text)
        self._backup_config()

    def _bas(self, name, field):
        if isinstance(field, torch.Tensor):
            field = field.cpu().numpy()
        write_bas(f"{self.dir}/{name}.bas", field, self.cfg.L0)

    def _backup_config(self):
        """The derived fields the run used (backup_config,
        msqg/qg.h:782-835): sig_filt = min(afilt Rd, Lfmax), Rd, psipg,
        frpg (from strl = (Fr/Ro)^2), qforc, topo, dh."""
        cfg, const = self.cfg, self.const
        nl, N = cfg.nl, cfg.N
        self._bas("sig_filt", const.sig_filt)
        self._bas(f"rdpg_{nl}l_N{N}", const.Rd)
        pp = np.zeros((nl, N, N), np.float32) if const.pp is None \
            else const.pp
        self._bas(f"psipg_{nl}l_N{N}", pp)
        if const.strl is not None:
            self._bas(f"frpg_{nl}l_N{N}",
                      (torch.sqrt(const.strl) * const.Ro).expand(nl - 1, N, N))
        if const.qforc is not None:
            self._bas(f"qforc_{nl}l_N{N}", const.qforc)
        if const.topo is not None:
            self._bas(f"topo_N{N}", const.topo)
        np.asarray(cfg.dh[:nl], np.float32).tofile(f"{self.dir}/dh_{nl}l.bin")

    def __call__(self, state, t):
        i = int(state.i)
        cfg = self.cfg
        self._bas(f"po{i:09d}", state.psi)
        self._bas(f"qo{i:09d}", state.q)
        if state.qof is not None and cfg.dtflt > 0:
            # the filter's mean eddy flux as a streamfunction, inverted
            # from a zero guess
            pf, _ = qg.invert_q(cfg, self.const, torch.zeros_like(state.qof),
                                state.qof)
            self._bas(f"pf{i:09d}", pf)
        if state.tracers is not None:
            self._bas(f"ptr{i:09d}", state.tracers.reshape(-1, cfg.N, cfg.N))

    def write_energy(self, energy, i):
        """Flush the window's energy budget, scaled by 1/dtout
        (msqg/qg.c:139-166)."""
        s = 1.0 / self.cfg.dtout
        for name in qg_energy.FIELDS:
            self._bas(f"{name}{i:09d}", getattr(energy, name) * s)


class PGOutputWriter:
    """mspg reference-compatible output (pg.c's events writeconst and
    writestate): psibt.bas at t = 0, then the running means b%09d.bas and
    u%09d.bas every dtout, with the two vertical ghost layers in the
    blocks (the reference dumps the nl+2 lists, pg.c:213-228, vertbc
    pg.h:374-387), so that the files round-trip through `load_pg_deck` and
    the reference's own input_matrixl. One process."""

    def __init__(self, cfg: PGConfig, const, outdir=None, params_text=None):
        self.cfg = cfg
        self.dir = create_outdir(outdir)
        if params_text is not None:
            with open(f"{self.dir}/params.in", "w") as f:
                f.write(params_text)
        write_bas(f"{self.dir}/psibt.bas", const.psibt.cpu().numpy(),
                  cfg.L0, y0=cfg.ys)

    def __call__(self, state, t):
        i = int(state.i)
        cfg = self.cfg
        b = state.b_me.cpu().numpy()
        ux = state.ux_me.cpu().numpy()
        uy = state.uy_me.cpu().numpy()
        bg = np.concatenate([b[:1], b, b[-1:]], axis=0)       # vertbc ghosts
        write_bas(f"{self.dir}/b{i:09d}.bas", bg, cfg.L0, y0=cfg.ys)
        # u_mel's (scalar *) flattening: [l.x, l.y] a sigma layer, ghosts
        # included; each face at its cell (the trailing wall face dropped)
        ux_c, uy_c = ux[:, :, :-1], uy[:, :-1, :]
        uxg = np.concatenate([ux_c[:1], ux_c, ux_c[-1:]], axis=0)
        uyg = np.concatenate([uy_c[:1], uy_c, uy_c[-1:]], axis=0)
        inter = np.stack([uxg, uyg], axis=1).reshape(-1, cfg.N, cfg.N)
        write_bas(f"{self.dir}/u{i:09d}.bas", inter, cfg.L0, y0=cfg.ys)


def stdout_hooks(stream=None) -> RunHooks:
    """The KE heartbeat of msqg/qg.c:101-109. The stream is looked up when
    a line is written, so a later redirection of sys.stdout is followed."""
    def log(i, dt, t, ke):
        print(f"i = {i}, dt = {dt:g}, t = {t:g}, ke_1 = {ke:g}",
              file=stream if stream is not None else sys.stdout)
    return RunHooks(on_log=log)


def main(argv=None) -> dict:
    """The command line; prints the KE log and, last, one JSON line with
    the steps, the model time, the wall time and the grid points a second,
    and returns that dict."""
    p = argparse.ArgumentParser(
        description="msom_tpu_torch msqg/mspg driver, the `./qg.e "
                    "params.in` / `./pg.e params.in` equivalent: "
                    "deck-directory input files, outdir_%%04d output")
    p.add_argument("--config", required=True, help="params.in path")
    p.add_argument("--model", choices=["qg", "pg"], default="qg")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--deck", default=None,
                   help="deck directory with input files (p0.bas, psipg_*, "
                        "b0.bas, ...); defaults to the config's directory")
    p.add_argument("--outdir", default=None,
                   help="output directory (default: next free outdir_%%04d)")
    p.add_argument("--no-output", action="store_true",
                   help="skip file output (stdout KE log only)")
    p.add_argument("--sharded", action="store_true",
                   help="domain decomposition over the ranks of torchrun "
                        "(torchrun --nproc_per_node=W -m "
                        "msom_tpu_torch.driver ...)")
    p.add_argument("--sharded-mode", choices=["auto", "rows", "gspmd"],
                   default="auto",
                   help="'rows': the rows step with the kernels' rows "
                        "mode; 'gspmd': the general-mesh step; 'auto': "
                        "rows where it takes the configuration, else "
                        "gspmd")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA card")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if args.sharded:
        dist.init(device)
    master = dist.is_master()

    with open(args.config) as f:
        params_text = f.read()
    deckdir = args.deck or os.path.dirname(os.path.abspath(args.config))
    log = print if master else (lambda *a, **k: None)
    t0 = time.time()
    hooks = stdout_hooks()
    if args.model == "pg":
        cfg = load_pg_config(params_text)
        deck = load_pg_deck(cfg, deckdir, log=log)
        const = mspg.build_constants(cfg, device=device, **deck["const"])
        state = mspg.init_state(cfg, const, **deck["init"])
        if not args.no_output and master:
            hooks.on_output = PGOutputWriter(cfg, const, outdir=args.outdir,
                                             params_text=params_text)
        state = run_pg(cfg, const=const, state=state, hooks=hooks,
                       max_steps=args.steps, sharded=args.sharded)
    else:
        cfg = load_qg_config(params_text)
        deck = load_qg_deck(cfg, deckdir, log=log)
        const = qg.build_constants(cfg, device=device, **deck["const"])
        state = qg.init_state(cfg, const, **deck["init"])
        if not args.no_output and master:
            hooks.on_output = OutputWriter(cfg, const, outdir=args.outdir,
                                           params_text=params_text)
        out = run_qg(cfg, const=const, state=state, hooks=hooks,
                     max_steps=args.steps,
                     sharded=args.sharded_mode if args.sharded else False)
        state = out[0]
    wall = time.time() - t0
    n_steps = int(state.i)
    result = {"steps": n_steps, "t": float(state.t), "wall_s": wall,
              "points_per_s": cfg.N * cfg.N * cfg.nl * n_steps
              / max(wall, 1e-9)}
    if args.sharded:
        result["ranks"] = dist.world_size()
        dist.shutdown()
    if master:
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
