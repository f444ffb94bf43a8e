"""Entry points of the port: the single-card forward step and the
multi-device dry run (the counterparts of the JAX package's
`__graft_entry__.py`, which stays as it is).

    python -m msom_tpu_torch.entry --device cpu --world W   # W gloo ranks
    torchrun --nproc-per-node W -m msom_tpu_torch.entry     # W cards, NCCL

`entry(device)` is the msqg model's forward step at N = 256, nl = 3, f32
(`__graft_entry__.py:7-25`). `dryrun_multichip(device)` runs one step of
every multi-device path on the running process group (torchrun's, or the
one `dist.init` started), in JAX's order (`__graft_entry__.py:27-238`):

* gspmd_mg, gspmd_spectral: the general-mesh step
  (`parallel/step.make_qg_step_sharded(mode="gspmd")`, the port's
  explicit form of JAX's GSPMD run) with the multigrid and the spectral
  inversion;
* shard_map_spectral, shard_map_mg: JAX's explicit shard_map step, whose
  two forms (under GSPMD and under shard_map) are one form in the port:
  the same general-mesh step on JAX's configurations (the mg one with
  flsrv, a tracer, psipg and topography);
* rows_kernel: the rows step (`mode="rows"`: K1 and K2 in rows mode, the
  pencil spectral solve) on the (W, 1) mesh at N_rows, asserted taken, and
  on a card its K1 rows and K2 rows launches;
* vshard_node: the vertex-sharded qg-node step (topography, a 3-D
  forcing, the stochastic kick), the sharded filter event, its ring put
  back, a second step;
* gspmd_mspg: the rows-sharded mspg step (`parallel/pg_step`) on the
  (W, 1) split of the same ranks.

The mesh is JAX's squarest (`parallel/mesh.mesh_shape`), N = max(32,
4 max(my, mx)) and N_rows = max(64, 8 W), as in JAX. Each mode checks a
finite KE (for mspg mean|b|) and, beyond JAX, holds the gathered state
after the step against the unsharded step from the same initial
condition on the same device, as the largest relative deviation
max|d f| / max|f| over the state's fields. The initial conditions come
from numpy seeds (JAX's jax.random draws cannot be reproduced in torch).
A CUDA run takes one card a rank and never falls back to gloo or the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from msom_tpu_torch.models import fused_rhs, fused_tracer, mspg, qg
from msom_tpu_torch.models import qg_node as node
from msom_tpu_torch.parallel import dist, spectral_shard, vshard
from msom_tpu_torch.parallel.mesh import make_mesh, mesh_shape
from msom_tpu_torch.parallel.pg_step import make_pg_step_sharded
from msom_tpu_torch.parallel.step import make_qg_step_sharded
from msom_tpu_torch.params import PGConfig, QGConfig

MODES = ("gspmd_mg", "gspmd_spectral", "shard_map_spectral", "shard_map_mg",
         "rows_kernel", "vshard_node", "gspmd_mspg")

# the flagship msqg physics (__graft_entry__.py:13-17)
PHYSICS = dict(nl=3, L0=80, Rom=0.025, Ekb=0.002, tau0=1e-4, Re4=1563,
               beta=0.5, Fr=(0.0023669, 0.0076173), dh=(0.06, 0.14, 0.8),
               DT=5e-2, CFL=0.6)
ENTRY = dict(PHYSICS, N=256, tend=500.0, dtout=1.0, dtype="float32")
TRACER = dict(nptr=1, Pe=(1e3,), ptr_r=(100.0,))
TNEXT = 0.5                  # the msqg modes' event time (JAX's)
SEED = 0                     # of the initial fields and the node's kick


def _require(device) -> None:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the entry points run on the "
                           "card unless asked for the CPU (device='cpu', "
                           "--device cpu)")


def entry(device="cuda", *, psi0=None):
    """(fn, (state, const, tnext)): the msqg forward step at N = 256,
    nl = 3, f32 (__graft_entry__.py:7-25); fn(state, const, tnext) ->
    (q, psi, ke). The state comes from `psi0` where given (carry JAX's
    init_state psi across to compare the two), else from qg.init_state's
    noise seeded with 0."""
    _require(device)
    cfg = QGConfig(**ENTRY).validate()
    const = qg.build_constants(cfg, device=device)
    state = qg.init_state(cfg, const, psi0=psi0)
    step = qg.make_step(cfg)

    def fn(state, const, tnext):
        new, diag = step(state, const, tnext)
        return new.q, new.psi, diag.ke

    return fn, (state, const, torch.tensor(1.0, dtype=torch.float32,
                                           device=device))


# ---------------------------------------------------------------------------
# the dry run's problems (numpy, so that a test can hand them to the JAX
# package too)
# ---------------------------------------------------------------------------

def sizes(world: int) -> dict:
    """The dry run's mesh and grid sizes on `world` ranks (JAX's)."""
    my, mx = mesh_shape(world)
    return dict(mesh=(my, mx), N=max(32, 4 * max(my, mx)),
                N_rows=max(64, 8 * world))


def qg_problem(mode: str, world: int, dtype: str = "float32"):
    """(config kwargs, fields, psi0, tracers0) of an msqg mode: JAX's
    configuration (__graft_entry__.py:57-63, :118-134, :146-158) and
    numpy-seeded initial fields (psi 1e-3 uniform noise, zero-mean a
    layer; tracers the same kind of noise)."""
    sz = sizes(world)
    N = sz["N_rows"] if mode == "rows_kernel" else sz["N"]
    kw = dict(PHYSICS, N=N, tend=1.0, dtout=1.0, dtype=dtype,
              solver="mg" if mode.endswith("_mg") else "spectral")
    y = np.linspace(0.0, 80.0, N)
    fields = {}
    if mode == "shard_map_mg":
        kw.update(flsrv=1, **TRACER)
        fields = dict(psipg=1e-3 * np.stack(
            [np.sin(np.pi * y / 80.0)[None, :] * np.ones((N, N))] * 3),
            topo=0.05 * np.outer(np.sin(np.pi * y / 80.0),
                                 np.sin(2 * np.pi * y / 80.0)))
    if mode == "rows_kernel":
        kw.update(TRACER)
        fields = dict(psipg=1e-3 * np.stack(
            [np.sin(np.pi * y / 80.0)[None, :] * np.ones((N, N))] * 3))
    rng = np.random.default_rng(SEED)
    psi0 = 1e-3 * rng.uniform(-1, 1, (3, N, N))
    psi0 = psi0 - psi0.mean(axis=(-2, -1), keepdims=True)
    tr0 = 1e-3 * rng.uniform(-1, 1, (3, kw["nptr"], N, N)) \
        if kw.get("nptr") else None
    return kw, fields, psi0, tr0


def node_problem(world: int, dtype: str = "float32", kick: bool = True):
    """(config kwargs, fields, psi0) of vshard_node: JAX's configuration
    (__graft_entry__.py:176-187) with amp_stoch 0 where `kick` is off and
    solver="vmg" (the inversion the vertex-sharded step runs whatever the
    config says, so that the unsharded step it is held against runs it
    too), and a numpy-seeded psi0 of init_state's kind (noise_init *
    (uniform noise + sin(2 pi y / L0)))."""
    N = sizes(world)["N"]
    yy = np.linspace(0.0, 1.0, N + 1)
    kw = dict(N=N, nl=2, L0=100.0, f0=46.5, beta=0.5, hEkb=1e-3, tau0=1e-3,
              tau1=5e-4, tf1=2.0, tf2=3.0, dy_ws=0.3, nu=5.0, dh=(0.5, 0.5),
              N2=(1.0,), noise_init=1e-3, bc_fac=1.0, DT=5e-2, tend=1.0,
              dtout=1.0, CFL=0.2, TOLERANCE=1e-6, dtype=dtype,
              stochastic=True, amp_stoch=1e-5 if kick else 0.0,
              L_filt_stoch=12.5, dtflt=0.5, Lfmax=30.0, Lfmin=10.0,
              solver="vmg")
    fields = dict(topo=0.1 * np.outer(np.sin(np.pi * yy),
                                      np.sin(2 * np.pi * yy)),
                  q_forcing_3d=1e-4 * np.ones((2, N + 1, N + 1)))
    rng = np.random.default_rng(SEED)
    yv = np.linspace(0.0, kw["L0"], N + 1)[:, None]
    psi0 = kw["noise_init"] * (rng.uniform(-1, 1, (2, N + 1, N + 1))
                               + np.sin(2 * np.pi * yv / kw["L0"]))
    return kw, fields, psi0


def pg_problem(world: int, dtype: str = "float32"):
    """The config kwargs of gspmd_mspg (__graft_entry__.py:209-212), run
    from rest."""
    return dict(N=sizes(world)["N"], nl=4, ys=0.3, r=0.02, tau_s=3e-2,
                tau0=0.12, kv=1e-4, kh=1e-4, omega=0.2, DT=1e-2, CFL=0.4,
                tend=0.1, dtout=1.0, dtype=dtype)


# ---------------------------------------------------------------------------
# the modes
# ---------------------------------------------------------------------------

def _rel(got: dict, want: dict) -> float:
    """max over the fields of max|got - want| / max|want|."""
    out = 0.0
    for k, w in want.items():
        scale = float(w.abs().max())
        err = float((got[k] - w).abs().max())
        out = max(out, err / scale if scale else err)
    return out


def _qg_mode(mode, world, device, dtype):
    kw, fields, psi0, tr0 = qg_problem(mode, world, dtype)
    cfg = QGConfig(**kw).validate()
    const = qg.build_constants(cfg, device=device, **fields)
    state = qg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
    rows = mode == "rows_kernel"
    rs = make_qg_step_sharded(
        cfg, device=device, const=const,
        **(dict(mode="rows") if rows else
           dict(mode="gspmd", mesh=sizes(world)["mesh"])))
    c = rs.shard(const)
    taken = rs.mode
    if rows and not (taken == "rows" and isinstance(
            c.spec, spectral_shard.PencilData)):
        raise RuntimeError("rows_kernel: the rows step did not take the "
                           "rows mode and the pencil solve")
    fused_rhs.rows_launches = fused_tracer.rows_launches = 0
    s, diag = rs.step(rs.shard(state), c, TNEXT)
    launches = dict(K1rows=fused_rhs.rows_launches,
                    K2rows=fused_tracer.rows_launches)
    if rows and torch.device(device).type == "cuda" and not (
            launches["K1rows"] and launches["K2rows"]):
        raise RuntimeError(f"rows_kernel: K1 rows and K2 rows did not both "
                           f"launch on the card ({launches})")
    g = rs.gather(s)
    want, _ = qg.make_step(cfg)(state, const, TNEXT)
    names = ("q", "psi") + (("tracers",) if cfg.nptr else ())
    got = {k: getattr(g, k) for k in names}
    return dict(ke=float(diag.ke), taken=taken, mesh=rs.mesh.shape,
                state=got, launches=launches,
                rel=_rel(got, {k: getattr(want, k) for k in names}))


def _node_mode(world, device, dtype, kick=True):
    kw, fields, psi0 = node_problem(world, dtype, kick)
    cfg = node.NodeQGConfig(**kw)
    const = node.build_constants(cfg, device=device, **fields)
    state = node.init_state(cfg, const, psi0=psi0)
    mesh = make_mesh(sizes(world)["mesh"])

    def gen():
        return torch.Generator(device=device).manual_seed(SEED)

    step, place, c = vshard.make_node_step_sharded(cfg, const, state.q, mesh,
                                                   generator=gen())
    filt = vshard.make_node_filter_sharded(cfg, mesh)
    s = place(vshard.owned_state(state))
    s, _ = step(s, c, 1e18)
    s, ring = filt(s, c)
    c = dataclasses.replace(c, ring=ring)
    s, diag = step(s, c, 1e18)
    g = vshard.full_state(s, c)
    ustep = node.make_step(cfg, gen())
    u, _ = ustep(state, const, 1e18)
    u = node.wavelet_filter(cfg, const, u)
    u, _ = ustep(u, const, 1e18)
    got = {"q": g.q, "psi": g.psi}
    return dict(ke=float(diag.ke), taken="vshard", mesh=mesh.shape,
                state=got, launches={},
                rel=_rel(got, {"q": u.q, "psi": u.psi}))


def _pg_mode(world, device, dtype):
    cfg = PGConfig(**pg_problem(world, dtype))
    const = mspg.build_constants(cfg, device=device)
    state = mspg.init_state(cfg, const)
    ps = make_pg_step_sharded(cfg)
    s, _ = ps.step(ps.shard(state), ps.shard(const), 1e9)
    g = ps.gather(s)
    u, _ = mspg.make_step(cfg)(state, const, 1e9)
    names = ("b", "ux", "uy")
    got = {k: getattr(g, k) for k in names}
    return dict(ke=float(g.b.abs().mean()), taken="rows",
                mesh=(world, 1), state=got, launches={},
                rel=_rel(got, {k: getattr(u, k) for k in names}))


def dryrun_multichip(device="cuda", *, dtype: str = "float32") -> dict:
    """One step of every multi-device path (module docstring) on the
    running process group (world size 1 without one); the ranks call it
    together. Returns {"world", "mesh", "N", "N_rows", "dtype", "modes":
    {name: {"ke", "rel", "taken", "mesh", "state" (the gathered whole
    fields, on the CPU), "launches", "seconds"}}, "line"}; rank 0 prints
    the line, JAX's `dryrun_multichip: ok on ...`. Raises where a KE is
    not finite or rows_kernel did not take its route."""
    _require(device)
    world = dist.world_size()
    if torch.device(device).type == "cuda" and \
            world > torch.cuda.device_count():
        raise RuntimeError(f"{world} ranks on {torch.cuda.device_count()} "
                           "cards: the dry run takes one card a rank")
    sz = sizes(world)
    out = {}
    for mode in MODES:
        t0 = time.perf_counter()
        if mode == "vshard_node":
            r = _node_mode(world, device, dtype)
        elif mode == "gspmd_mspg":
            r = _pg_mode(world, device, dtype)
        else:
            r = _qg_mode(mode, world, device, dtype)
        if not np.isfinite(r["ke"]):
            raise RuntimeError(f"{mode}: a KE that is not finite "
                               f"({r['ke']})")
        r["state"] = {k: v.detach().cpu() for k, v in r["state"].items()}
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        r["seconds"] = time.perf_counter() - t0
        out[mode] = r
    my, mx = sz["mesh"]
    summary = ", ".join(f"{k}={v['ke']:.3e}" for k, v in out.items())
    line = (f"dryrun_multichip: ok on {world} ranks (mesh {my}x{mx}, "
            f"N={sz['N']}, {summary})")
    if dist.is_master():
        print(line, flush=True)
    return dict(world=world, mesh=sz["mesh"], N=sz["N"],
                N_rows=sz["N_rows"], dtype=dtype, modes=out, line=line)


# ---------------------------------------------------------------------------
# launching
# ---------------------------------------------------------------------------

def _report(res: dict) -> None:
    """Each mode's line: KE, deviation from the unsharded step, route,
    seconds."""
    for k, r in res["modes"].items():
        print(f"  {k}: ke {r['ke']:.6e}, against the unsharded step "
              f"{r['rel']:.3e}, {r['taken']} on {r['mesh'][0]}x"
              f"{r['mesh'][1]}, {r['seconds']:.2f} s", flush=True)


def _cpu_rank(rank, world, store, dtype):
    torch.set_num_threads(1)
    dist.init("cpu", init_method=f"file://{store}", world_size=world,
              rank=rank)
    try:
        res = dryrun_multichip("cpu", dtype=dtype)
    finally:
        dist.shutdown()
    if rank == 0:
        _report(res)


def run_cpu(world: int, dtype: str = "float32") -> None:
    """Spawn `world` gloo ranks on the CPU, each running
    dryrun_multichip("cpu", dtype=dtype)."""
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp()
    try:
        mp.spawn(_cpu_rank, args=(world, f"{tmp}/store", dtype),
                 nprocs=world, join=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m msom_tpu_torch.entry",
        description="The multi-device dry run: every sharded path one "
                    "step on W ranks, against the unsharded step.")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--world", type=int, default=None,
                   help="ranks to spawn on the CPU (with --device cpu); "
                        "on cards, torchrun's --nproc-per-node")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "float64"))
    args = p.parse_args(argv)
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if args.device == "cpu" and not torchrun:
        run_cpu(args.world or 1, args.dtype)
        return 0
    _require(args.device)
    if args.device == "cuda":
        world = int(os.environ.get("WORLD_SIZE", 1))
        if args.world not in (None, world):
            raise RuntimeError(f"--world {args.world} on cards: start the "
                               "ranks with torchrun --nproc-per-node "
                               f"{args.world}")
        if world > torch.cuda.device_count():
            raise RuntimeError(f"{world} ranks on "
                               f"{torch.cuda.device_count()} cards: one "
                               "card a rank")
    dist.init(args.device)
    master = dist.is_master()
    try:
        res = dryrun_multichip(args.device, dtype=args.dtype)
    finally:
        dist.shutdown()
    if master:
        _report(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
