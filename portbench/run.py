"""Run one cell of the benchmark of the PyTorch/CUDA port once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout that holds BENCHMARK.json. It needs CUDA cards,
as many as the cell asks for, and exits 2, printing no result, without
them. Standard error ends with each number compared beside its limit;
the last line of standard output is the result, one JSON object.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# top-level module names that must not be loaded in a run: JAX and the
# JAX package the port was made from (compared as whole names)
FORBIDDEN = {"jax", "jaxlib", "flax", "msom_tpu"}


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & FORBIDDEN)


def _finite(x):
    """A number for the JSON line: inf and nan as strings."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]

    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"cell {args.workload} needs {chips} CUDA card(s); found "
              f"{found}", file=sys.stderr)
        return 2

    from portbench import harness
    res = harness.run_cell(bench, args.workload, seed=args.seed,
                           seconds=args.seconds, trace_on=bool(args.trace),
                           device="cuda", t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    checks = res["checks"]
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": res["device"]}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                      for k, c in checks.items()}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
