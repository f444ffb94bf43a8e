"""The ranks of tests/test_torch_shard_mg.py and tests/test_torch_mesh_step.py:
one process a rank, started by torch.multiprocessing.spawn, in a gloo group
on a file:// store. A rank imports torch, numpy and the port only (the JAX
references are computed in the tests' own process). `run(world, job, tmp)`
spawns the ranks on the job and returns rank 0's results; each rank runs
every part of the job in turn, so a world size costs one spawn.

The job, a dict saved with torch.save, holds any of:

* "halo": [mesh shape]: every rank's ghosted_sharded ring (Dirichlet,
  Neumann, periodic) and ghosted_slip_sharded ring of fields made from
  seeds, gathered;
* "mg": {name: (mesh shape, config kwargs, tol)}: solve_layered_sharded
  of a seeded right-hand side from zero, gathered, with its MGStats;
* "spectral": {name: (mesh shape, N, nl, periodic)}: transform_sharded
  forward and inverse and solve_spectral_sharded of a seeded field,
  gathered;
* "steps": {name: (config kwargs, fields, psi0, tr0, steps, mode, mesh)}:
  the sharded step from the whole state, gathered, with each step's (dt,
  ke, V-cycles), the mode and the mesh taken;
* "driver": {name: (config kwargs, fields, psi0, tr0, max_steps,
  sharded)}: run_qg's (q, psi, mode), or ("raises", type name, message).
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


def _gather_list(x):
    """Every rank's tensor `x` (one shape), in rank order."""
    import torch.distributed as td
    parts = [torch.empty_like(x) for _ in range(td.get_world_size())]
    td.all_gather(parts, x.contiguous())
    return parts


def halo_fields(N):
    """The fields of the halo units: a (3, N, N) field and a zeta, psi
    pair."""
    rng = np.random.default_rng(11)
    return tuple(torch.as_tensor(rng.standard_normal((3, N, N)))
                 for _ in range(3))


def halo_units(shapes):
    """{shape: {law: [every rank's ghost ring]}} at N = 32."""
    from msom_tpu_torch.ops.bc import BC
    from msom_tpu_torch.parallel import halo
    from msom_tpu_torch.parallel.mesh import make_mesh
    a, z, p = halo_fields(32)
    out = {}
    for shape in shapes:
        mesh = make_mesh(shape)
        rows, cols = mesh.tile(32, 32)
        res = {}
        for bc in (BC.DIRICHLET, BC.NEUMANN, BC.PERIODIC):
            res[bc.value] = _gather_list(
                halo.ghosted_sharded(a[:, rows, cols], bc, mesh).p)
        pg = halo.ghosted_sharded(p[:, rows, cols], BC.DIRICHLET, mesh)
        for sbc in (0.0, 5.0):
            res[f"slip{sbc:g}"] = _gather_list(halo.ghosted_slip_sharded(
                z[:, rows, cols].contiguous(), pg, sbc, 0.25, mesh).p)
        out[shape] = res
    return out


def mg_problem(kw):
    """(levels, b, cfg, const) of the multigrid units: the config's layered
    levels and a seeded right-hand side."""
    from msom_tpu_torch.models import qg
    cfg = _config(kw)
    const = qg.build_constants(cfg, device="cpu")
    b = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (cfg.nl, cfg.N, cfg.N)))
    return const.levels, b, cfg, const


def mg_units(job):
    """{name: (the gathered solution, MGStats)}."""
    from msom_tpu_torch.models import qg
    from msom_tpu_torch.parallel import halo, shard_mg
    from msom_tpu_torch.parallel.mesh import make_mesh
    out = {}
    for name, (shape, kw, tol) in job.items():
        levels, b, cfg, const = mg_problem(kw)
        mesh = make_mesh(shape)
        rows, cols = mesh.tile(cfg.N, cfg.N)
        bl = b[:, rows, cols].contiguous()
        a, st = shard_mg.solve_layered_sharded(
            torch.zeros_like(bl), bl, levels=shard_mg.shard_levels(
                levels, mesh), idh0=const.idh0, idh1=const.idh1,
            bc=qg._bc_psi(cfg), tolerance=tol)
        out[name] = (halo.gather_global(a, mesh), st)
    return out


def spectral_problem(N, nl, periodic, refine=False):
    """(SpectralData with the matmul basis, q) of the spectral units; with
    refine, the bf16 + refinement solve's data."""
    from msom_tpu_torch.solvers import spectral
    kw = dict(dh=np.array([0.06, 0.14, 0.8]),
              s_profile=np.array([8.96, 0.97])) if nl > 1 else {}
    sd = spectral.build_spectral(nl=nl, N=N, L0=80.0, periodic=periodic,
                                 dtype=torch.float64, transform="matmul",
                                 refine=refine, device="cpu", **kw)
    q = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (nl, N, N)))
    return sd, q


def spectral_units(job):
    """{name: (forward transform, inverse transform, solve), gathered};
    the solve is the refine solve where the job asks for it."""
    from msom_tpu_torch.parallel import halo, spectral_shard
    from msom_tpu_torch.parallel.mesh import make_mesh
    out = {}
    for name, (shape, N, nl, periodic, refine) in job.items():
        sd, q = spectral_problem(N, nl, periodic, refine)
        mesh = make_mesh(shape)
        rows, cols = mesh.tile(N, N)
        ql = q[:, rows, cols].contiguous()
        fwd = spectral_shard.transform_sharded(ql, sd.S, inverse=False,
                                               mesh=mesh)
        inv = spectral_shard.transform_sharded(ql, sd.S, inverse=True,
                                               mesh=mesh)
        psi = spectral_shard.solve_spectral_sharded(
            spectral_shard.mesh_data(sd, mesh), ql)
        out[name] = tuple(halo.gather_global(x, mesh)
                          for x in (fwd, inv, psi))
    return out


def steps(job):
    """{name: (q, psi, tracers, [(dt, ke, cycles)], mode, mesh shape)}."""
    from msom_tpu_torch.models import qg
    from msom_tpu_torch.parallel.step import make_qg_step_sharded
    out = {}
    for name, (kw, fields, psi0, tr0, n, mode, mesh) in job.items():
        cfg = _config(kw)
        const = qg.build_constants(cfg, device="cpu", **fields)
        state = qg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
        rs = make_qg_step_sharded(cfg, device="cpu", mode=mode, mesh=mesh,
                                  const=const)
        s, c = rs.shard(state), rs.shard(const)
        diags = []
        for _ in range(n):
            s, d = rs.step(s, c, 1e9)
            diags.append((float(d.dt), float(d.ke), d.mg_iters))
        g = rs.gather(s)
        out[name] = (g.q, g.psi, g.tracers, diags, rs.mode, rs.mesh.shape)
    return out


def driver(job):
    """{name: (q, psi, mode) of run_qg, or ("raises", type, message)}."""
    from msom_tpu_torch import driver as tdriver
    from msom_tpu_torch.models import qg
    out = {}
    for name, (kw, fields, psi0, tr0, max_steps, sharded) in job.items():
        cfg = _config(kw)
        const = qg.build_constants(cfg, device="cpu", **fields)
        state = qg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
        try:
            s, _, mode = tdriver.run_qg(cfg, const=const, state=state,
                                        max_steps=max_steps,
                                        sharded=sharded, device="cpu")
            out[name] = (s.q, s.psi, mode)
        except (ValueError, NotImplementedError) as e:
            out[name] = ("raises", type(e).__name__, str(e))
    return out


def main(rank, world, store, jobpath, outpath):
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    from msom_tpu_torch.parallel import dist
    dist.init("cpu", init_method=f"file://{store}", world_size=world,
              rank=rank)
    job = torch.load(jobpath, weights_only=False)
    parts = {"halo": halo_units, "mg": mg_units, "spectral": spectral_units,
             "steps": steps, "driver": driver}
    out = {name: fn(job[name]) for name, fn in parts.items()
           if job.get(name)}
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
