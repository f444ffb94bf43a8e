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
  sharded)}: run_qg's (q, psi, mode), or ("raises", type name, message);
* "overlap": the halo/compute overlap (halo.ghosted_issue and the
  overlapped stencils), each run twice, with the interior/rim split on
  every tile (halo.SPLIT_MIN_BYTES = 0) and with the shipped rule (these
  tiles are below it: the whole ring summed after the wait): "rings"
  [mesh shape] (a mesh of fewer ranks than the world runs on its first
  ranks), "steps" {name: (config kwargs, fields, psi0, tr0, steps, mesh)}
  of the general-mesh step, "mg" {mesh shape: (config kwargs, tol)} of
  solve_layered_sharded, and "spy" a mesh shape on which the order of the
  transfers' posts and waits and of the stencils' adds is logged;
* "entry": a dtype: msom_tpu_torch.entry's dry run (dryrun_multichip) and
  its vshard_node mode with the stochastic kick off.
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


def _split_and_whole(fn):
    """{"split": fn(), "whole": fn()}: fn run with the interior/rim split
    on every tile (halo.SPLIT_MIN_BYTES = 0), then with the shipped
    threshold."""
    from msom_tpu_torch.parallel import halo
    shipped, out = halo.SPLIT_MIN_BYTES, {}
    for form, limit in (("split", 0), ("whole", shipped)):
        halo.SPLIT_MIN_BYTES = limit
        try:
            out[form] = fn()
        finally:
            halo.SPLIT_MIN_BYTES = shipped
    return out


def overlap_rings(shapes):
    """{(shape, law): every rank's (issued ring == ghosted_sharded's,
    overlapped neighbour sum == the plain one, overlapped Laplacian == the
    plain one), bit for bit} on seeded 32^2 x 3 fields; a rank off a mesh
    of fewer ranks than the world gives (True, True, True)."""
    import torch.distributed as td
    from msom_tpu_torch.ops.bc import BC
    from msom_tpu_torch.ops.ghost import laplacian_g, neighbor_sum
    from msom_tpu_torch.parallel import halo
    from msom_tpu_torch.parallel.mesh import Mesh
    a, _, _ = halo_fields(32)
    rank, out = td.get_rank(), {}
    for shape in shapes:
        my, mx = shape
        for bc in (BC.DIRICHLET, BC.NEUMANN, BC.PERIODIC):
            flags = torch.ones(3, dtype=torch.bool)
            if rank < my * mx:
                mesh = Mesh(my, mx, *divmod(rank, mx))
                rows, cols = mesh.tile(32, 32)
                t = a[:, rows, cols].contiguous()
                g = halo.ghosted_sharded(t, bc, mesh)
                flags[0] = torch.equal(halo.ghosted_issue(t, bc, mesh).wait()
                                       .p, g.p)
                flags[1] = torch.equal(halo.neighbor_sum_overlap(
                    t, bc, mesh), neighbor_sum(g))
                flags[2] = torch.equal(halo.laplacian_overlap(
                    t, bc, 0.3, mesh), laplacian_g(g, 0.3))
            out[shape, bc.value] = _gather_list(flags)
    return out


def overlap_spy(shape):
    """The order of events on rank 0 of a `shape` mesh: "post" where a
    batch of transfers is posted, "wait" where one is waited on, "issue"
    where halo.ghosted_issue starts, and the name of every torch add; for
    one general-mesh spectral step, one sharded relaxation sweep and one
    sharded residual, with the split on every tile and with the shipped
    rule."""
    import torch.distributed as td
    from torch.overrides import TorchFunctionMode
    from msom_tpu_torch.ops.bc import BC
    from msom_tpu_torch.parallel import halo, shard_mg
    from msom_tpu_torch.parallel.mesh import make_mesh
    from msom_tpu_torch.parallel.step import make_qg_step_sharded
    log = []

    class Adds(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "__name__", "")
            if name in ("add", "add_"):
                log.append(name)
            return func(*args, **(kwargs or {}))

    class Work:
        def __init__(self, w):
            self.w = w

        def wait(self):
            log.append("wait")
            return self.w.wait()

    post, issue = td.batch_isend_irecv, halo.ghosted_issue

    def spy_post(ops):
        log.append("post")
        return [Work(w) for w in post(ops)]

    def spy_issue(*args):
        log.append("issue")
        return issue(*args)

    kw = dict(MESH_SPY, solver="spectral")
    cfg = _config(kw)
    from msom_tpu_torch.models import qg
    const = qg.build_constants(cfg, device="cpu")
    state = qg.init_state(cfg, const, seed=3)
    mesh = make_mesh(shape)
    mg_cfg = _config(dict(MESH_SPY, solver="mg"))
    mg_const = qg.build_constants(mg_cfg, device="cpu")
    levels = shard_mg.shard_levels(mg_const.levels, mesh)
    lvl = levels.levels[0]
    rows, cols = mesh.tile(cfg.N, cfg.N)
    b = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (cfg.nl, cfg.N, cfg.N)))[:, rows, cols].contiguous()
    rs = make_qg_step_sharded(cfg, device="cpu", mode="gspmd", mesh=shape,
                              const=const)
    s, c = rs.shard(state), rs.shard(const)

    def run():
        out = {}
        td.batch_isend_irecv, halo.ghosted_issue = spy_post, spy_issue
        try:
            for part, fn in (
                    ("step", lambda: rs.step(s, c, 1e9)),
                    ("relax", lambda: shard_mg._relax_sharded(
                        b, b, lvl, 1, BC.DIRICHLET, mesh)),
                    ("residual", lambda: shard_mg._residual_sharded(
                        b, b, lvl, BC.DIRICHLET, mg_const.idh0,
                        mg_const.idh1, mesh))):
                log.clear()
                with Adds():
                    fn()
                out[part] = list(log)
        finally:
            td.batch_isend_irecv, halo.ghosted_issue = post, issue
        return out

    return _split_and_whole(run)


# the spy's configuration: a small walled msqg grid
MESH_SPY = dict(N=32, nl=3, L0=80, Rom=0.025, Ekb=0.002, tau0=1e-4,
                Re4=1563, beta=0.5, Fr=(0.0023669, 0.0076173),
                dh=(0.06, 0.14, 0.8), DT=5e-2, tend=1.0, dtout=1.0,
                CFL=0.6, dtype="float64")


def overlap(job):
    """The "overlap" part (module docstring)."""
    out = {}
    if job.get("rings"):
        out["rings"] = _split_and_whole(lambda: overlap_rings(job["rings"]))
    if job.get("steps"):
        out["steps"] = {name: _split_and_whole(lambda: steps({name: (
            kw, fields, psi0, tr0, n, "gspmd", mesh)})[name])
            for name, (kw, fields, psi0, tr0, n, mesh)
            in job["steps"].items()}
    if job.get("mg"):
        out["mg"] = {shape: _split_and_whole(lambda: mg_units({shape: (
            shape, kw, tol)})[shape])
            for shape, (kw, tol) in job["mg"].items()}
    if job.get("spy"):
        out["spy"] = overlap_spy(job["spy"])
    return out


def entry_run(dtype):
    """The "entry" part (module docstring): {"dryrun": dryrun_multichip's
    result, "node_nokick": vshard_node's with amp_stoch = 0, its state on
    the CPU}."""
    import torch.distributed as td
    from msom_tpu_torch import entry
    res = entry.dryrun_multichip("cpu", dtype=dtype)
    r = entry._node_mode(td.get_world_size(), "cpu", dtype, kick=False)
    r["state"] = {k: v.detach().cpu() for k, v in r["state"].items()}
    return {"dryrun": res, "node_nokick": r}


def main(rank, world, store, jobpath, outpath):
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    from msom_tpu_torch.parallel import dist
    dist.init("cpu", init_method=f"file://{store}", world_size=world,
              rank=rank)
    job = torch.load(jobpath, weights_only=False)
    parts = {"halo": halo_units, "mg": mg_units, "spectral": spectral_units,
             "steps": steps, "driver": driver, "overlap": overlap,
             "entry": entry_run}
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
