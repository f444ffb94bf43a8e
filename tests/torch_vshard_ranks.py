"""The ranks of tests/test_torch_vshard.py and tests/test_torch_pg_shard.py:
one process a rank, started by torch.multiprocessing.spawn (world size 1:
the calling process), in a gloo group on a file:// store
(tests/torch_mesh_ranks.py's pattern). A rank imports
torch, numpy and the port only; the JAX references are computed in the
tests' own process. `run(world, job, tmp)` spawns the ranks on the job and
returns rank 0's results; each rank runs every part of the job in turn, so
a world size costs one spawn.

The job, a dict saved with torch.save, holds any of:

* "units": {name: (mesh shape, config kwargs, fields, psi0, psi, t)}:
  vpoisson_sharded of the state's q from its psi (gathered, with the
  V-cycles), and rhs_pv_sharded and diag_1d_sharded of (q, `psi`);
* "steps": {name: (mesh shape, config kwargs, fields, psi0, plan, seed)}:
  the sharded step from the whole state through `plan`, a string of "s"
  (a step) and "f" (the filter event), a generator seeded with `seed`
  where the config is stochastic; the whole q, psi and psi_f with the
  (dt, ke, V-cycles) of every step;
* "driver": {name: (config kwargs, fields, psi0, outdir, max_steps)}:
  run_node(sharded=True) with its files in outdir (the master's), the
  whole q and psi returned;
* "pg": {name: (PGConfig kwargs, b0, max_steps, outdir)}:
  run_pg(sharded=True), with a PGOutputWriter into outdir on the master
  where outdir is given: the whole state's b, ux, uy, b_me, ux_me, uy_me,
  t, i, nme; with b0 None only make_pg_step_sharded (None); or
  ("raises", type name, message).
"""

from __future__ import annotations

import dataclasses
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def node_problem(kw, fields, psi0):
    """(cfg, const, state) of a qg-node case on the CPU."""
    from msom_tpu_torch.models import qg_node as node
    cfg = node.NodeQGConfig(**kw)
    const = node.build_constants(cfg, device="cpu", **fields)
    state = node.init_state(cfg, const, psi0=psi0)
    return cfg, const, state


def units(job):
    """{name: (psi, V-cycles, dq, (ke, d_ke, f_ke))}, gathered whole."""
    from msom_tpu_torch.parallel import halo, vshard
    from msom_tpu_torch.parallel.mesh import make_mesh
    out = {}
    for name, (shape, kw, fields, psi0, psi_in, t) in job.items():
        cfg, const, state = node_problem(kw, fields, psi0)
        mesh = make_mesh(shape)
        _, place, c = vshard.make_node_step_sharded(cfg, const, state.q,
                                                    mesh)
        s = place(vshard.owned_state(state))
        psi, st = vshard.vpoisson_sharded(
            s.psi, s.q, levels=c.vlevels, sharded_flags=c.sharded_flags,
            mesh=mesh, idh0=c.idh0, idh1=c.idh1, tolerance=cfg.TOLERANCE)
        psi = vshard.bc_psi_own(psi, mesh)
        p = halo.local_tile(vshard.to_owned(torch.as_tensor(psi_in)), mesh)
        tt = torch.tensor(t, dtype=torch.float64)
        dq = vshard.rhs_pv_sharded(cfg, c, s.q, p, tt)
        diag = vshard.diag_1d_sharded(cfg, c, p, s.q, tt)
        out[name] = (halo.gather_global(psi, mesh), st.iters,
                     halo.gather_global(dq, mesh),
                     tuple(float(x) for x in diag))
    return out


def steps(job):
    """{name: (q, psi, psi_f, [(dt, ke, V-cycles)])}, whole."""
    from msom_tpu_torch.parallel import vshard
    from msom_tpu_torch.parallel.mesh import make_mesh
    out = {}
    for name, (shape, kw, fields, psi0, plan, seed) in job.items():
        cfg, const, state = node_problem(kw, fields, psi0)
        mesh = make_mesh(shape)
        gen = torch.Generator().manual_seed(seed) if cfg.stochastic \
            else None
        step, place, c = vshard.make_node_step_sharded(
            cfg, const, state.q, mesh, generator=gen)
        filt = vshard.make_node_filter_sharded(cfg, mesh) \
            if "f" in plan else None
        s = place(vshard.owned_state(state))
        diags = []
        for act in plan:
            if act == "f":
                s, ring = filt(s, c)
                c = dataclasses.replace(c, ring=ring)
            else:
                s, d = step(s, c, 1e18)
                diags.append((float(d.dt), float(d.ke), d.mg_iters))
        g = vshard.full_state(s, c)
        out[name] = (g.q, g.psi, g.psi_f, diags)
    return out


def driver(job):
    """{name: (q, psi) of run_node(sharded=True), whole}."""
    from msom_tpu_torch import driver_node
    out = {}
    for name, (kw, fields, psi0, outdir, max_steps) in job.items():
        cfg, const, state = node_problem(kw, fields, psi0)
        s, _ = driver_node.run_node(cfg, const=const, state=state,
                                    outdir=outdir, restart=None,
                                    max_steps=max_steps, sharded=True,
                                    device="cpu")
        out[name] = (s.q, s.psi)
    return out


def pg(job):
    """{name: the whole state's fields of run_pg(sharded=True), or
    ("raises", type, message)}."""
    from msom_tpu_torch import driver
    from msom_tpu_torch.models import mspg
    from msom_tpu_torch.parallel import dist
    from msom_tpu_torch.parallel.pg_step import make_pg_step_sharded
    from msom_tpu_torch.params import PGConfig
    out = {}
    for name, (kw, b0, max_steps, outdir) in job.items():
        cfg = PGConfig(**kw)
        try:
            if b0 is None:
                out[name] = make_pg_step_sharded(cfg) and None
                continue
            const = mspg.build_constants(cfg, device="cpu")
            state = mspg.init_state(cfg, const, b0=b0)
            hooks = driver.RunHooks()
            if outdir is not None and dist.is_master():
                hooks.on_output = driver.PGOutputWriter(cfg, const, outdir)
            s = driver.run_pg(cfg, const=const, state=state, hooks=hooks,
                              max_steps=max_steps, sharded=True,
                              device="cpu")
        except ValueError as e:
            out[name] = ("raises", type(e).__name__, str(e))
            continue
        out[name] = {k: getattr(s, k) for k in
                     ("b", "ux", "uy", "b_me", "ux_me", "uy_me", "t", "i",
                      "nme")}
    return out


def main(rank, world, store, jobpath, outpath):
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    from msom_tpu_torch.parallel import dist
    dist.init("cpu", init_method=f"file://{store}", world_size=world,
              rank=rank)
    job = torch.load(jobpath, weights_only=False)
    parts = {"units": units, "steps": steps, "driver": driver, "pg": pg}
    try:
        out = {name: fn(job[name]) for name, fn in parts.items()
               if job.get(name)}
    finally:
        dist.shutdown()
    if rank == 0:
        torch.save(out, outpath)


def run(world: int, job: dict, tmp) -> dict:
    """Run `job` on `world` ranks (files under the directory `tmp`) and
    return rank 0's results: spawned processes, or at world size 1 a
    gloo group of this process, ended before the return."""
    import torch.multiprocessing as mp
    jobpath, outpath = f"{tmp}/job{world}.pt", f"{tmp}/out{world}.pt"
    torch.save(job, jobpath)
    args = (world, f"{tmp}/store{world}", jobpath, outpath)
    if world == 1:
        main(0, *args)
    else:
        mp.spawn(main, args=args, nprocs=world, join=True)
    return torch.load(outpath, weights_only=False)
