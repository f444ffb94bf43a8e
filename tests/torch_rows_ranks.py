"""The ranks of tests/test_torch_rows_step.py: one process a rank, started
by torch.multiprocessing.spawn, in a gloo group on a file:// store. A rank
imports torch, numpy and the port only (the JAX references are computed
in the test's own process). `run(world, job, tmp)` spawns the ranks on the
job and returns rank 0's results; each rank runs every part of the job
in turn, so a world size costs one spawn.

The job, a dict saved with torch.save: "units" (the halo, pencil and
reduction units), "steps" ({name: (config kwargs, fields, psi0, tr0,
steps[, mesh shape])}), "driver" ((config kwargs, fields, psi0, tr0, outdir)),
"roundtrip" (the leaves of a QGState).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(kw):
    from msom_tpu_torch.params import QGConfig
    return QGConfig(**kw).validate()


def units(rank, world):
    """The halo exchanges, the pencil solve, the reductions and
    fetch_global, on fields made from seeds alike on every rank."""
    from msom_tpu_torch.ops.bc import BC
    from msom_tpu_torch.parallel import dist, halo, spectral_shard
    from msom_tpu_torch.parallel.mesh import make_mesh
    from msom_tpu_torch.solvers import spectral
    mesh = make_mesh((world, 1))
    N = 64
    n = N // world
    rows = slice(rank * n, (rank + 1) * n)
    a = torch.as_tensor(np.random.default_rng(1).standard_normal((3, N, N)))
    out = {"ext": {wrap: halo.ext_rows8(a[:, rows].contiguous(), wrap)
                   for wrap in (False, True)},
           "ghost": {bc.value: halo.ghosted_sharded(a[0, rows], bc, mesh).p
                     for bc in (BC.DIRICHLET, BC.NEUMANN, BC.PERIODIC)}}
    v = torch.tensor([rank, -rank, 1.5 * rank], dtype=torch.float64)
    out["pmax"], out["psum"] = halo.pmax(v), halo.psum(v)
    out["fetch"] = dist.fetch_global(a[:, rows])
    # every rank gets the master's string; the count of those that did
    name = dist.broadcast_str("outdir_0007" if dist.is_master() else None)
    dist.sync()
    out["bcast"] = halo.psum(torch.tensor(float(name == "outdir_0007")))
    out["pencil"] = {}
    for periodic in (False, True):
        for transform in (("matmul",) if periodic else ("matmul",
                                                         "factored")):
            for nl in (1, 3):
                kw = dict(dh=np.array([0.06, 0.14, 0.8]),
                          s_profile=np.array([8.96, 0.97])) if nl > 1 else {}
                sd = spectral.build_spectral(
                    nl=nl, N=N, L0=80.0, periodic=periodic,
                    dtype=torch.float64, transform=transform, device="cpu",
                    **kw)
                q = torch.as_tensor(
                    np.random.default_rng(2).standard_normal((nl, N, N)))
                pd = spectral_shard.pencil_data(sd, rank, world)
                out["pencil"][periodic, transform, nl] = dist.fetch_global(
                    spectral_shard.solve_spectral_pencil(
                        pd, q[:, rows].contiguous()))
    return out


def steps(job):
    """{name: (q, psi, tracers, dt, ke, mode) of the whole state after the
    steps}; a job's entry may end in a mesh shape (my, mx)."""
    from msom_tpu_torch.models import qg
    from msom_tpu_torch.parallel.step import make_qg_step_sharded
    out = {}
    for name, (kw, fields, psi0, tr0, n, *mesh) in job.items():
        cfg = _config(kw)
        const = qg.build_constants(cfg, device="cpu", **fields)
        state = qg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
        rs = make_qg_step_sharded(cfg, device="cpu", mesh=(mesh or [None])[0],
                                  const=const)
        s, c = rs.shard(state), rs.shard(const)
        for _ in range(n):
            s, diag = rs.step(s, c, 1e9)
        g = rs.gather(s)
        out[name] = (g.q, g.psi, g.tracers, float(diag.dt), float(diag.ke),
                     rs.mode)
    return out


def driver(rank, job):
    """run_qg(sharded="rows") with an OutputWriter on every rank, each in
    its own directory: only the master's may hold records."""
    from msom_tpu_torch import driver as tdriver
    from msom_tpu_torch.models import qg
    kw, fields, psi0, tr0, outdir = job
    cfg = _config(kw)
    const = qg.build_constants(cfg, device="cpu", **fields)
    state = qg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
    hooks = tdriver.RunHooks()
    hooks.on_output = tdriver.OutputWriter(cfg, const,
                                           outdir=f"{outdir}/rank{rank}")
    state, _, mode = tdriver.run_qg(cfg, const=const, state=state,
                                    hooks=hooks, sharded="rows",
                                    device="cpu")
    return state.q, mode


def roundtrip(leaves):
    """shard then gather of a whole QGState: the leaves back."""
    from msom_tpu_torch import convert
    from msom_tpu_torch.parallel.step import make_qg_step_sharded
    cfg = _config(leaves.pop("cfg"))
    state = convert.state_from_numpy(cfg, leaves, device="cpu")
    rs = make_qg_step_sharded(cfg, device="cpu")
    return convert.state_to_numpy(rs.gather(rs.shard(state)))


def main(rank, world, store, jobpath, outpath):
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    from msom_tpu_torch.parallel import dist
    dist.init("cpu", init_method=f"file://{store}", world_size=world,
              rank=rank)
    job = torch.load(jobpath, weights_only=False)
    out = {}
    if job.get("units"):
        out["units"] = units(rank, world)
    if job.get("steps"):
        out["steps"] = steps(job["steps"])
    if job.get("driver"):
        out["driver"] = driver(rank, job["driver"])
    if job.get("roundtrip"):
        out["roundtrip"] = roundtrip(dict(job["roundtrip"]))
    dist.shutdown()
    if rank == 0:
        torch.save(out, outpath)


def run(world: int, job: dict, tmp) -> dict:
    """Spawn `world` ranks on `job` (files under the directory `tmp`);
    rank 0's results."""
    import torch.multiprocessing as mp
    jobpath, outpath = f"{tmp}/job{world}.pt", f"{tmp}/out{world}.pt"
    torch.save(job, jobpath)
    mp.spawn(main, args=(world, f"{tmp}/store{world}", jobpath, outpath),
             nprocs=world, join=True)
    return torch.load(outpath, weights_only=False)
