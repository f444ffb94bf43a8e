"""The readings that the limits of a cell's comparison are set from, in one
process (the benchmark's own runs never run this):

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3
        --seconds 3 --systems program,control [--out FILE]

For every system and seed, one run of the cell with a window of `seconds`
and the comparison, printed as one JSON line: the run's numbers
(q_err, psi_err, t_err, steps_off), its step_ms and whether
its compared numbers met the cell's limits.

  program   the port, as the cell runs it: its numbers over a dozen seeds
            or more give each number's lower reading
  control   the cell's control, which the comparison has to fail, as its
            file's "control" states it:
            {"program_tf32": true}, the port with TF32 on in its matrix
            products (the nearest precision below float32 with TF32
            off); or {"reference_dtype": "<type>"}, the plain reference
            computed in that type put in the program's place (bfloat16
            for a float32 path that has no matrix product, float32 for
            a float64 one)
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import harness  # noqa: E402


class ReferenceSystem:
    """The plain reference in the program's place, in `dtype`."""

    def __init__(self, cell: harness.Cell, device: str, dtype, root=None):
        ref = harness.load_module((root or harness.ROOT) / "reference"
                                  / f"{cell.config['reference']}.py")
        self.model = ref.Model(cell.config["keys"], dtype=dtype,
                               device=device)

    def start(self, psi0):
        return self.model.initial(psi0)

    def call(self, state, steps, done):
        return self.model.advance(state, steps)

    @staticmethod
    def steps_done(state):
        return state.i

    @staticmethod
    def snapshot(state):
        return {"q": state.q.clone(), "psi": state.psi.clone(),
                "t": state.t.clone(), "dt_prev": state.dt_prev.clone(),
                "i": state.i}

    def counting(self):
        return contextlib.nullcontext()

    def release(self):
        pass


@contextlib.contextmanager
def tf32():
    """TF32 on in matrix products, restored on leaving."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class ProgramTF32:
    """The program with TF32 on in its matrix products in every call."""

    def __init__(self, system):
        self.system = system

    def __getattr__(self, name):
        return getattr(self.system, name)

    def call(self, state, steps, done):
        with tf32():
            return self.system.call(state, steps, done)


def control_system(cell: harness.Cell, device: str, root=None):
    """The system that the cell's "control" puts in the program's place."""
    spec = cell.spec["control"]
    if set(spec) == {"reference_dtype"}:
        return ReferenceSystem(cell, device,
                               getattr(torch, spec["reference_dtype"]), root)
    if spec == {"program_tf32": True}:
        return ProgramTF32(harness.make_system(cell, device,
                                               root or harness.ROOT))
    raise ValueError(f"{cell.name}: unknown control {spec!r}")


def control_run(bench, name, *, seed, seconds, device="cuda", root=None):
    """One run of cell `name` with its control in the program's place."""
    root = root or harness.ROOT
    cell = harness.find_cell(bench, name, root)
    return harness.run_cell(bench, name, seed=seed, seconds=seconds,
                            trace_on=False, device=device, root=root,
                            system=control_system(cell, device, root))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--systems", default="program,control")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("readings need a CUDA card", file=sys.stderr)
        return 2
    bench = json.loads((harness.REPO / "BENCHMARK.json").read_text())
    out = open(args.out, "a") if args.out else None
    try:
        for which in args.systems.split(","):
            for seed in (int(s) for s in args.seeds.split(",")):
                t0 = time.perf_counter()
                if which == "program":
                    res = harness.run_cell(bench, args.workload, seed=seed,
                                           seconds=args.seconds,
                                           trace_on=False)
                else:
                    res = control_run(bench, args.workload, seed=seed,
                                      seconds=args.seconds)
                line = json.dumps({
                    "workload": args.workload, "system": which,
                    "seed": seed, "numbers": res["numbers"],
                    "correct": res["correct"],
                    "step_ms": res["metrics"].get("step_ms", {})
                    .get("value"), "items": res["attempted"],
                    "seconds": time.perf_counter() - t0})
                print(line, flush=True)
                if out:
                    print(line, file=out, flush=True)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
