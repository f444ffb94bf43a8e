"""The halo overlap's interior/rim split against the whole-ring form, on W
ranks: the port's general-mesh ("gspmd") msqg step at bench.py's 4-layer
configuration, on the squarest mesh of the world (parallel/mesh.py).

    torchrun --nproc-per-node 4 tools/halo_split_bench.py       # 4 cards
    python tools/halo_split_bench.py --device cpu --world 4 \\
        --cases mg:64,spectral:64 --steps 2                     # gloo check

Each case ("solver:N") runs three forms of the same step in turns, each
from the same state: "shipped" (halo.SPLIT_MIN_BYTES as it is: the split
from a tile of that size up), "split" (the limit 0: every tile with an
interior) and "whole" (no tile: each ring is waited on, then summed
whole). Each form takes --warm steps, then --rounds rounds of --steps
steps timed with CUDA events on every rank (the host clock on the CPU).
Rank 0 prints each form's median and range over the rounds of the
slowest rank's ms/step, the V-cycles of its first solve a step, and
whether every rank's final q and psi are bit for bit equal across the
forms; with --out it writes the same as JSON. Imports torch, numpy and
the port only.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from msom_tpu_torch.models import qg  # noqa: E402
from msom_tpu_torch.parallel import dist, halo  # noqa: E402
from msom_tpu_torch.parallel.mesh import mesh_shape  # noqa: E402
from msom_tpu_torch.parallel.step import make_qg_step_sharded  # noqa: E402
from msom_tpu_torch.params import QGConfig  # noqa: E402

FORMS = ("shipped", "split", "whole")
NL = 4


def bench_config(N: int, solver: str) -> QGConfig:
    """bench.py's 4-layer Verron variant scaled to N (bench.py:63-68); the
    multigrid at bench's tolerance 1e-3."""
    return QGConfig(N=N, nl=NL, L0=80, Rom=0.025, Ekb=0.002, tau0=1e-4,
                    Re4=1563 * (N / 256) ** 3, beta=0.5,
                    Fr=tuple([0.003] * (NL - 1)), dh=tuple([1.0 / NL] * NL),
                    DT=5e-2, tend=1e9, dtout=1e9, CFL=0.6, dtype="float32",
                    solver=solver,
                    **(dict(tol=1e-3) if solver == "mg" else {})).validate()


def _timer(device):
    """ms of fn() over n calls: CUDA events on a card, else the host
    clock."""
    if torch.device(device).type == "cuda":
        def ms(fn, n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / n
    else:
        def ms(fn, n):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            return 1e3 * (time.perf_counter() - t0) / n
    return ms


def run_case(solver: str, N: int, device, args) -> dict:
    """The three forms of one case (module docstring)."""
    import torch.distributed as td
    world = dist.world_size()
    cfg = bench_config(N, solver)
    const = qg.build_constants(cfg, device=device)
    psi0 = 1e-3 * np.random.default_rng(0).uniform(-1, 1, (NL, N, N))
    state = qg.init_state(cfg, const, psi0=psi0)
    rs = make_qg_step_sharded(cfg, device=device, const=const, mode="gspmd",
                              mesh=mesh_shape(world))
    c, s0 = rs.shard(const), rs.shard(state)
    del const, state
    limits = {"shipped": halo.SPLIT_MIN_BYTES, "split": 0,
              "whole": math.inf}
    box = {f: s0 for f in FORMS}
    cycles = {f: [] for f in FORMS}
    timer = _timer(device)

    def stepper(f):
        def one():
            halo.SPLIT_MIN_BYTES = limits[f]
            try:
                box[f], d = rs.step(box[f], c, 1e18)
            finally:
                halo.SPLIT_MIN_BYTES = limits["shipped"]
            cycles[f].append(int(getattr(d, "mg_iters", 0)))
        return one

    for f in FORMS:
        for _ in range(args.warm):
            stepper(f)()
        cycles[f].clear()
    ms = {f: [] for f in FORMS}
    for _ in range(args.rounds):
        for f in FORMS:
            t = torch.tensor([timer(stepper(f), args.steps)],
                             dtype=torch.float64, device=device)
            if world > 1:
                td.all_reduce(t, op=td.ReduceOp.MAX)
            ms[f].append(float(t))
    same = torch.tensor([float(all(
        torch.equal(getattr(box[f], k), getattr(box["shipped"], k))
        for f in FORMS for k in ("q", "psi")))], device=device)
    if world > 1:
        td.all_reduce(same, op=td.ReduceOp.MIN)
    tile = tuple(s0.q.shape)
    return dict(solver=solver, N=N, mesh=list(rs.mesh.shape),
                tile=list(tile),
                tile_bytes=int(np.prod(tile)) * s0.q.element_size(),
                split_min_bytes=limits["shipped"],
                forms={f: dict(med=float(np.median(ms[f])), ms=ms[f],
                               cycles=cycles[f]) for f in FORMS},
                bitwise=bool(same.item()))


def _report(res: dict) -> None:
    for r in res["cases"]:
        base = r["forms"]["whole"]["med"]
        print(f"halo split {r['solver']} {r['N']}^2 x {NL} f32 on "
              f"{res['world']} ranks, mesh {r['mesh'][0]}x{r['mesh'][1]}, "
              f"tile {r['tile']} ({r['tile_bytes']} B; the split from "
              f"{r['split_min_bytes']:.0f} B): "
              + "; ".join(
                  f"{f} {v['med']:.4f} ms/step (range {min(v['ms']):.4f}-"
                  f"{max(v['ms']):.4f}, ratio to whole "
                  f"{v['med'] / base:.4f}, V-cycles "
                  f"{sorted(set(v['cycles']))})"
                  for f, v in r["forms"].items())
              + f"; final q and psi bit for bit equal on every rank: "
              f"{r['bitwise']}", flush=True)


def bench(device, args) -> dict:
    cases = [(c.split(":")[0], int(c.split(":")[1]))
             for c in args.cases.split(",")]
    res = dict(world=dist.world_size(), device=str(device),
               cases=[run_case(s, n, device, args) for s, n in cases])
    if torch.device(device).type == "cuda":
        import subprocess
        res["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()
    return res


def _finish(res, args) -> None:
    _report(res)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    if not all(r["bitwise"] for r in res["cases"]):
        raise SystemExit("the forms' final states differ")


def _cpu_rank(rank, world, store, args):
    torch.set_num_threads(1)
    dist.init("cpu", init_method=f"file://{store}", world_size=world,
              rank=rank)
    try:
        res = bench("cpu", args)
    finally:
        dist.shutdown()
    if rank == 0:
        _finish(res, args)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--world", type=int, default=1,
                   help="gloo ranks to spawn with --device cpu")
    p.add_argument("--cases", default="mg:2048,spectral:2048,mg:4096")
    p.add_argument("--warm", type=int, default=3)
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if args.device == "cpu":
        import torch.multiprocessing as mp
        tmp = tempfile.mkdtemp()
        try:
            mp.spawn(_cpu_rank, args=(args.world, f"{tmp}/store", args),
                     nprocs=args.world, join=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device (use --device cpu for gloo ranks)")
    dist.init("cuda")
    try:
        res = bench("cuda", args)
    finally:
        master = dist.is_master()
        dist.shutdown()
    if master:
        _finish(res, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
