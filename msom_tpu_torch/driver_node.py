"""Run loops and events of the qg-node family: the qg-node model, newqg and
SQG (the port of `msom_tpu.driver_node`), and their command line, the
`./qg.e params.in` equivalent:

    python -m msom_tpu_torch.driver_node [--model node|newqg|sqg]
        --config params.in [--steps N] [--deck DIR] [--outdir DIR]
        [--restart PATH] [--cpu]
    torchrun --nproc_per_node=W -m msom_tpu_torch.driver_node --config
        params.in --sharded

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

The sharded qg-node run (`run_node(sharded=True)`, `--sharded`) steps the
owned-node vertex tiles of the ranks of a torch.distributed group
(parallel/vshard.py); the events gather the whole fields on every rank and
the writers run on the master. newqg and SQG ignore `--sharded` and run
unsharded, as the JAX package's command line does.
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
from msom_tpu_torch.parallel import dist, vshard
from msom_tpu_torch.parallel.mesh import Mesh, make_mesh

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


class _NoOutput:
    """The output of a rank other than the master in a sharded run: it
    writes nothing."""
    dir = None

    def write(self, t, **fields):
        pass

    def diag_header(self):
        pass

    def diag_row(self, *values):
        pass

    def backup_restart(self, path):
        pass

    def backup_file(self, path):
        pass

    def close(self):
        pass


def _maybe_restart(path: str | None):
    """`path` if it names an existing file, else None."""
    if path and os.path.exists(path):
        return path
    return None


def run_node(cfg, *, const=None, state=None, hooks: RunHooks | None = None,
             max_steps: int | None = None, outdir=None, output=None,
             restart: str | None = "restart.nc", params_text=None,
             deck: str | None = None, sharded=False, mesh=None,
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
    from one made here and seeded with `seed`.

    `sharded` runs the owned-node vertex step (parallel/vshard.py) on the
    ranks of the running process group (world size 1 without one) laid
    out as `mesh` (a Mesh or an (my, mx) shape; default make_mesh's),
    each rank calling run_node with the same arguments: the vertex
    multigrid inverts (its levels are built where `const` has the
    spectral solve), a stochastic run draws the same noise on every rank
    (the generators seeded alike), the events gather the whole fields on
    every rank, the writers and the hooks run on the master (the output
    of the other ranks writes nothing). The state returned is the whole
    state on every rank; psi_f's ring row and column N are zero, as in
    the JAX package's sharded run. A periodic config raises
    NotImplementedError, as the JAX package does."""
    if sharded and cfg.periodic:
        raise NotImplementedError(vshard.PERIODIC_REFUSAL)
    master = not sharded or dist.is_master()
    hooks = hooks if hooks is not None and master else RunHooks()
    deck_nc = None
    if const is None:
        kw = {}
        if deck is not None:
            d = load_node_deck(cfg, deck, log=print if master else None)
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

    if not master:
        output = _NoOutput()
    elif output is None:
        output = NodeOutput(cfg, outdir, params_text=params_text)
    if rp:
        output.backup_restart(rp)
    if deck_nc:
        output.backup_file(deck_nc)
    if cfg.stochastic and generator is None:
        generator = torch.Generator(device=state.q.device).manual_seed(seed)
    if sharded:
        return _run_node_sharded(cfg, const, state, hooks, max_steps, output,
                                 mesh, generator)
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


def _run_node_sharded(cfg, const, state, hooks, max_steps, output, mesh,
                      generator):
    """run_node's event loop on the vertex-sharded step (the JAX
    package's _run_node_sharded, msom_tpu/driver_node.py:249-325): the
    output, diag and filter events of the unsharded loop, the first two on
    the gathered whole fields."""
    if not isinstance(mesh, Mesh):
        mesh = make_mesh(mesh)
    step, place, csh = vshard.make_node_step_sharded(
        cfg, const, state.q, mesh=mesh, generator=generator)
    filt = vshard.make_node_filter_sharded(cfg, mesh) if cfg.dtflt > 0 \
        else None
    s = place(vshard.owned_state(state))
    master = dist.is_master()

    t = float(s.t)
    eps = _time_eps(t, s.t.dtype)
    next_out = 0.0                               # output fires at t = 0
    next_diag = 0.0 if cfg.dtdiag > 0 else float("inf")
    next_flt = _next_event(t, cfg.dtflt, eps)
    wrote_header = False

    while True:
        if t >= next_out - eps:
            g = vshard.full_state(s, csh)        # a collective
            if master:
                psi = g.psi
                if int(s.i) == 0:                # qg.c:163-166
                    psi, _ = node.invert_q(cfg, const, g.psi, g.q)
                output.write(t, psi=psi, q=g.q)
                if hooks.on_output is not None:
                    hooks.on_output(g, t)
            s = dataclasses.replace(s, nbar=torch.zeros_like(s.nbar))
            next_out = _next_event(t, cfg.dtout, eps)
        if cfg.dtdiag > 0 and t >= next_diag - eps:
            if not wrote_header:
                output.diag_header()
                wrote_header = True
            else:
                g = vshard.full_state(s, csh)
                if master:
                    ke, d_ke, f_ke = (float(x) for x in node.diag_1d(
                        cfg, const, g.psi, g.q,
                        torch.tensor(t, dtype=s.t.dtype, device=s.t.device)))
                    output.diag_row(t, ke, d_ke, f_ke)
            next_diag = _next_event(t, cfg.dtdiag, eps)
        if cfg.dtflt > 0 and t >= next_flt - eps:
            s, ring = filt(s, csh)
            csh = dataclasses.replace(csh, ring=ring)
            if hooks.on_filter is not None:
                hooks.on_filter(s, t)
            next_flt = _next_event(t, cfg.dtflt, eps)
        if t >= cfg.tend - eps:
            break

        tnext = min(next_out, next_diag, next_flt, cfg.tend)
        s, diag = step(s, csh, tnext)
        t = float(s.t)
        i = int(s.i)
        eps = _time_eps(t, s.t.dtype)
        if t != t:
            raise FloatingPointError(
                f"non-finite model time after step {i}: blow-up or NaN "
                "(check DT/CFL; resume from the last restart.nc)")
        if hooks.on_log is not None:
            hooks.on_log(i, float(diag.dt), t, float(diag.ke))
        if max_steps is not None and i >= max_steps:
            break
    output.close()
    return vshard.full_state(s, csh), output


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
                   help="the vertex-sharded step over the ranks of torchrun "
                        "(torchrun --nproc_per_node=W -m "
                        "msom_tpu_torch.driver_node ...; qg-node model "
                        "only, newqg and sqg ignore it)")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    with open(args.config) as f:
        text = f.read()
    kw = dict(hooks=stdout_hooks(), max_steps=args.steps, outdir=args.outdir,
              restart=args.restart, params_text=text, device=device)
    if args.model == "newqg":
        from msom_tpu_torch.models.newqg import load_newqg_config
        return run_newqg(load_newqg_config(text), **kw)
    cfg = node.load_node_config(text)
    if args.model == "sqg":
        return run_sqg(cfg, **kw)
    deck = args.deck or os.path.dirname(os.path.abspath(args.config))
    if not args.sharded:
        return run_node(cfg, deck=deck, **kw)
    dist.init(device)
    try:
        return run_node(cfg, deck=deck, sharded=True, **kw)
    finally:
        dist.shutdown()


if __name__ == "__main__":
    main()
