"""Run loops and events of the qg-node family: the qg-node model, newqg and
SQG (the port of `msom_tpu.driver_node`), and their command line, the
`./qg.e params.in` equivalent:

    python -m msom_tpu_torch.driver_node [--model node|newqg|sqg]
        --config params.in [--steps N] [--deck DIR] [--outdir DIR]
        [--restart PATH] [--cpu]

The reference's event schedule (qg-node/qg.c:130-179, qg.h:361-400,
486-499) becomes a host loop around the step: a `vars.nc` NetCDF record of
psi and q on the (N+1)^2 vertex grid every dtout (at t = 0 too, with the
re-inversion of step 0), `diag_1d.dat` (its header at the first diag event,
then `t, ke, dissipation, forcing` rows every dtdiag), the masked wavelet
filter every dtflt, the automatic `restart.nc` pickup (psi at its last
record, backed up into the output directory) and the deck's backup. The
wandering-gyre wind is recomputed inside the step from the model time, so
the reference's per-step `event forcing` needs no host hook. The loop reads
the model time to the host once a step; event times are compared within
`driver._time_eps`, so a float32 run lands on every event.

newqg (`run_newqg`, reference newqg/qg.c:50-99): a cell-centred vars.nc
record of psi and q every dtout (at t = 0 too), the restart.nc pickup
(psi) and the KE heartbeat. SQG (`run_sqg`, qg-node built with -DSQG): the
same events with the surface buoyancy bs as a third vars.nc variable, and
psi and bs read from restart.nc (qg-node/qg.h:492-495).

One process. Not ported yet: the sharded run (`sharded=`, `--sharded`:
the owned-node vertex step parallel/vshard.py and run_node(sharded=),
ROADMAP.md queue 1, item 15d), which raises NotImplementedError.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil

import torch

from msom_tpu_torch.driver import (RunHooks, _next_event, _time_eps,
                                   create_outdir, stdout_hooks)
from msom_tpu_torch.io.deck import load_node_deck
from msom_tpu_torch.io.netcdf import NCWriter, read_nc
from msom_tpu_torch.models import qg_node as node
from msom_tpu_torch.ops import vertex

UNPORTED = {
    "sharded": "the sharded qg-node run (the owned-node vertex step "
               "parallel/vshard.py, run_node(sharded=)) is not ported yet "
               "(ROADMAP.md queue 1, item 15d)",
}


class NodeOutput:
    """vars.nc, diag_1d.dat and the config backup of the node-family
    drivers."""

    def __init__(self, cfg, outdir: str | None = None, *,
                 var_names=("psi", "q"), vertex=True, params_text=None):
        self.dir = create_outdir(outdir)
        self.nc = NCWriter(os.path.join(self.dir, "vars.nc"),
                           list(var_names), cfg.N,
                           nl=cfg.nl if cfg.nl > 1 else None, L0=cfg.L0,
                           vertex=vertex, surface_vars=("bs",))
        if params_text is not None:
            with open(os.path.join(self.dir, "params.in"), "w") as f:
                f.write(params_text)
        self._diag_path = os.path.join(self.dir, "diag_1d.dat")

    def write(self, t, **fields):
        """One vars.nc record; tensors are rounded to float32 on their
        device, then copied to the host."""
        self.nc.append(t, **{
            k: v.to(torch.float32).cpu().numpy()
            if isinstance(v, torch.Tensor) else v for k, v in fields.items()})

    def diag_header(self):
        with open(self._diag_path, "a") as f:
            f.write("# time, ke, dissipation, forcing\n")

    def diag_row(self, t, ke, d_ke, f_ke):
        with open(self._diag_path, "a") as f:
            f.write(f"{t:e}, {ke:e}, {d_ke:e}, {f_ke:e}\n")

    def backup_restart(self, path):
        """Copy the consumed restart.nc into the output directory
        (backup_file, qg-node/qg.h:497)."""
        shutil.copy(path, os.path.join(self.dir, "restart.nc.bak"))

    def backup_file(self, path):
        """Copy a consumed input file into the output directory (backup_file,
        qg-node/extra.h:137-178; the reference backs up
        input_vars_<nl>l_N<N>.nc at init, qg_baroclinic_ms.h:492)."""
        shutil.copy(path, os.path.join(self.dir, os.path.basename(path)))

    def close(self):
        self.nc.close()


def _maybe_restart(path: str | None):
    """`path` if it names an existing file, else None."""
    if path and os.path.exists(path):
        return path
    return None


def run_node(cfg, *, const=None, state=None, hooks: RunHooks | None = None,
             max_steps: int | None = None, outdir=None, output=None,
             restart: str | None = "restart.nc", params_text=None,
             deck: str | None = None, sharded=False,
             generator: torch.Generator | None = None, seed: int = 0,
             device="cuda"):
    """Integrate the qg-node model to cfg.tend with the reference's event
    schedule; returns (state, output).

    `deck`: a directory with input_vars_<nl>l_N<N>.nc (N2, psi_pg, mask,
    topo, q_forcing_3d, qg_baroclinic_ms.h:478-495), backed up into the
    output directory. `const` and `state` default to
    `build_constants(cfg, device=device)` and its `init_state`; an
    existing `restart` file replaces psi (and q, t) by its last record. A
    stochastic run draws from `generator` (on the state's device), else
    from one made here and seeded with `seed`."""
    if sharded:
        raise NotImplementedError(UNPORTED["sharded"])
    hooks = hooks or RunHooks()
    deck_nc = None
    if const is None:
        kw = {}
        if deck is not None:
            d = load_node_deck(cfg, deck, log=print)
            kw, deck_nc = d["const"], d["path"]
        const = node.build_constants(cfg, device=device, **kw)
    if state is None:
        state = node.init_state(cfg, const)
    rp = _maybe_restart(restart)
    if rp:
        fields, t0 = read_nc(rp, ["psi"])
        dtype, dev = state.q.dtype, state.q.device
        psi = torch.as_tensor(fields["psi"].reshape(
            cfg.nl, cfg.N + 1, cfg.N + 1), dtype=dtype).to(dev)
        if cfg.periodic:
            psi = psi[..., :-1, :-1].contiguous()   # drop the wrapped copy
        else:
            psi = vertex.bc_psi(psi)
        state = dataclasses.replace(
            state, psi=psi, q=node.comp_q(cfg, const, psi),
            t=torch.tensor(t0, dtype=dtype, device=dev))

    if output is None:
        output = NodeOutput(cfg, outdir, params_text=params_text)
    if rp:
        output.backup_restart(rp)
    if deck_nc:
        output.backup_file(deck_nc)
    if cfg.stochastic and generator is None:
        generator = torch.Generator(device=state.q.device).manual_seed(seed)
    step = node.make_step(cfg, generator)

    t = float(state.t)
    eps = _time_eps(t, state.t.dtype)
    next_out = 0.0                               # output fires at t = 0
    next_diag = 0.0 if cfg.dtdiag > 0 else float("inf")
    next_flt = _next_event(t, cfg.dtflt, eps)
    wrote_header = False

    def fire_output(state, t):
        # at i == 0 the reference re-inverts before writing (qg.c:163-166)
        psi = state.psi
        if int(state.i) == 0:
            psi, _ = node.invert_q(cfg, const, state.psi, state.q)
        output.write(t, psi=node.to_vertex_full(cfg, psi),
                     q=node.to_vertex_full(cfg, state.q))
        if hooks.on_output is not None:
            hooks.on_output(state, t)
        return dataclasses.replace(state, nbar=torch.zeros_like(state.nbar))

    while True:
        if t >= next_out - eps:
            state = fire_output(state, t)
            next_out = _next_event(t, cfg.dtout, eps)
        if cfg.dtdiag > 0 and t >= next_diag - eps:
            if not wrote_header:
                output.diag_header()
                wrote_header = True
            else:
                ke, d_ke, f_ke = (float(x) for x in node.diag_1d(
                    cfg, const, state.psi, state.q,
                    torch.tensor(t, dtype=state.t.dtype,
                                 device=state.t.device)))
                output.diag_row(t, ke, d_ke, f_ke)
            next_diag = _next_event(t, cfg.dtdiag, eps)
        if cfg.dtflt > 0 and t >= next_flt - eps:
            state = node.wavelet_filter(cfg, const, state)
            if hooks.on_filter is not None:
                hooks.on_filter(state, t)
            next_flt = _next_event(t, cfg.dtflt, eps)
        if t >= cfg.tend - eps:
            break

        tnext = min(next_out, next_diag, next_flt, cfg.tend)
        state, diag = step(state, const, tnext)
        t = float(state.t)
        i = int(state.i)
        eps = _time_eps(t, state.t.dtype)
        if t != t:
            raise FloatingPointError(
                f"non-finite model time after step {i}: blow-up or NaN "
                "(check DT/CFL; resume from the last restart.nc)")
        if hooks.on_log is not None:
            hooks.on_log(i, float(diag.dt), t, float(diag.ke))
        if max_steps is not None and i >= max_steps:
            break
    output.close()
    return state, output


def _event_loop(state, step, output, hooks, cadence, tend, max_steps,
                write):
    """The newqg and SQG drivers' loop: `write(state, t)` at t = 0 and
    every `cadence`, a step to the next event or `tend`, the heartbeat;
    event times within `driver._time_eps`. Returns the state."""
    t = float(state.t)
    eps = _time_eps(t, state.t.dtype)
    next_out = 0.0
    while True:
        if t >= next_out - eps:
            write(state, t)
            if hooks.on_output is not None:
                hooks.on_output(state, t)
            next_out = _next_event(t, cadence, eps)
        if t >= tend - eps:
            break
        state, diag = step(state, min(next_out, tend))
        t = float(state.t)
        i = int(state.i)
        eps = _time_eps(t, state.t.dtype)
        if t != t:
            raise FloatingPointError(
                f"non-finite model time after step {i} (check DT/CFL)")
        if hooks.on_log is not None:
            hooks.on_log(i, float(diag.dt), t, float(diag.ke))
        if max_steps is not None and i >= max_steps:
            break
    output.close()
    return state


def run_newqg(cfg, *, lam=None, state=None, hooks: RunHooks | None = None,
              max_steps: int | None = None, outdir=None, output=None,
              restart: str | None = "restart.nc", params_text=None,
              device="cuda"):
    """Integrate newqg to cfg.tend (the reference's newqg/qg.c loop);
    returns (state, output). `lam` (the Helmholtz field of
    `newqg.build_levels`) and `state` default to ones made here on
    `device` (the state's device wins); an existing `restart` file
    replaces psi (and q, t) by its last record."""
    from msom_tpu_torch.models import newqg
    hooks = hooks or RunHooks()
    if state is not None:
        device = state.q.device
    if lam is None:
        _, lam = newqg.build_levels(cfg, device)
    if state is None:
        state = newqg.init_state(cfg, lam, device=device)
    rp = _maybe_restart(restart)
    if rp:
        fields, t0 = read_nc(rp, ["psi"])
        dtype = state.q.dtype
        psi = torch.as_tensor(fields["psi"].reshape(cfg.nl, cfg.N, cfg.N),
                              dtype=dtype).to(device)
        zero = torch.zeros((), dtype=dtype, device=device)
        state = newqg.NewQGState(
            q=newqg.comp_q(cfg, lam, psi), psi=psi,
            t=torch.tensor(t0, dtype=dtype, device=device),
            dt_prev=zero, i=torch.zeros((), dtype=torch.int32,
                                        device=device))
    if output is None:
        output = NodeOutput(cfg, outdir, vertex=False,
                            params_text=params_text)
    if rp:
        output.backup_restart(rp)
    step = newqg.make_step(cfg, device=device)
    state = _event_loop(state, step, output, hooks, cfg.dtout, cfg.tend,
                        max_steps, lambda s, t: output.write(t, psi=s.psi,
                                                             q=s.q))
    return state, output


def run_sqg(cfg, *, const=None, state=None, hooks: RunHooks | None = None,
            max_steps: int | None = None, outdir=None, output=None,
            restart: str | None = "restart.nc", params_text=None,
            device="cuda"):
    """Integrate the SQG variant to cfg.tend (qg-node with -DSQG: bs is
    prognostic, written to vars.nc and read from restart.nc, qg-node/
    qg.h:492-495); returns (state, output). `const` and `state` default
    to `sqg.build_constants(cfg, device=device)` and its `init_state`."""
    from msom_tpu_torch.models import sqg
    hooks = hooks or RunHooks()
    if const is None:
        const = sqg.build_constants(cfg, device=device)
    if state is None:
        state = sqg.init_state(cfg, const)
    rp = _maybe_restart(restart)
    if rp:
        fields, t0 = read_nc(rp, ["psi", "bs"])
        dtype, dev = state.q.dtype, state.q.device
        M = cfg.N + 1
        psi = vertex.bc_psi(torch.as_tensor(
            fields["psi"].reshape(cfg.nl, M, M), dtype=dtype).to(dev))
        bs = torch.as_tensor(fields["bs"].reshape(M, M),
                             dtype=dtype).to(dev)
        state = dataclasses.replace(
            state, psi=psi, bs=bs, q=sqg.comp_q(cfg, const, psi, bs),
            t=torch.tensor(t0, dtype=dtype, device=dev))
    if output is None:
        output = NodeOutput(cfg, outdir, var_names=("psi", "q", "bs"),
                            params_text=params_text)
    if rp:
        output.backup_restart(rp)
    step = sqg.make_step(cfg)
    state = _event_loop(
        state, lambda s, tn: step(s, const, tn), output, hooks, cfg.dtout,
        cfg.tend, max_steps,
        lambda s, t: output.write(t, psi=s.psi, q=s.q, bs=s.bs))
    return state, output


def main(argv=None):
    """The command line: `--model node` runs `run_node` from the config
    and the deck beside it (or `--deck`), `--model newqg` runs `run_newqg`
    from a newqg params.in, `--model sqg` runs `run_sqg` from a qg-node
    params.in; each prints the KE heartbeat, on the CUDA card unless
    `--cpu`. Returns (state, output)."""
    p = argparse.ArgumentParser(
        description="msom_tpu_torch node-family driver, the `./qg.e "
                    "params.in` equivalent: input_vars_<nl>l_N<N>.nc from "
                    "the deck directory, outdir_%%04d output")
    p.add_argument("--model", choices=["node", "newqg", "sqg"],
                   default="node")
    p.add_argument("--config", required=True, help="params.in path")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--outdir", default=None)
    p.add_argument("--restart", default="restart.nc")
    p.add_argument("--deck", default=None,
                   help="deck directory with input_vars_<nl>l_N<N>.nc; "
                        "defaults to the config's directory")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA card")
    p.add_argument("--sharded", action="store_true",
                   help="vertex-sharded step over the local devices")
    args = p.parse_args(argv)
    if args.sharded:
        raise NotImplementedError(UNPORTED["sharded"])
    with open(args.config) as f:
        text = f.read()
    kw = dict(hooks=stdout_hooks(), max_steps=args.steps, outdir=args.outdir,
              restart=args.restart, params_text=text,
              device="cpu" if args.cpu else "cuda")
    if args.model == "newqg":
        from msom_tpu_torch.models.newqg import load_newqg_config
        return run_newqg(load_newqg_config(text), **kw)
    cfg = node.load_node_config(text)
    if args.model == "sqg":
        return run_sqg(cfg, **kw)
    deck = args.deck or os.path.dirname(os.path.abspath(args.config))
    return run_node(cfg, deck=deck, **kw)


if __name__ == "__main__":
    main()
