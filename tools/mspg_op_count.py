#!/usr/bin/env python3
"""Count the torch operators of one mspg step on the CPU.

    python3 tools/mspg_op_count.py [N nl]

Builds bench.py's mspg configuration (64^2 x 30 f32 by default,
chip_smoke.py's PG_PHYSICS and PG_PATH) on the CPU, takes three steps,
then profiles one with torch.profiler and prints the number of top-level
aten operators and of those that are not views (slices, selects, expands
and the like launch no kernel on a card). The second count is the step's
launch estimate on the card; it is a count, not a device time.
"""

import collections
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

VIEWS = {"aten::slice", "aten::select", "aten::view", "aten::expand",
         "aten::unsqueeze", "aten::unbind", "aten::narrow",
         "aten::as_strided", "aten::alias", "aten::reshape", "aten::detach",
         "aten::t", "aten::transpose", "aten::permute", "aten::lift_fresh",
         "aten::empty", "aten::empty_like", "aten::resolve_conj",
         "aten::resolve_neg", "aten::_unsafe_view", "aten::squeeze"}


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from msom_tpu_torch.models import mspg
    from msom_tpu_torch.params import PGConfig

    size = dict(chip_smoke.PG_PATH)
    if len(sys.argv) == 3:
        size.update(N=int(sys.argv[1]), nl=int(sys.argv[2]))
    cfg = PGConfig(**chip_smoke.PG_PHYSICS, **size)
    const = mspg.build_constants(cfg, device="cpu")
    state = mspg.init_state(cfg, const)
    step = mspg.make_step(cfg)
    for _ in range(3):
        state, _ = step(state, const, 1e18)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = step(state, const, 1e18)
    top = [e.name for e in prof.events() if e.name.startswith("aten::")
           and not (e.cpu_parent is not None
                    and e.cpu_parent.name.startswith("aten::"))]
    counts = collections.Counter(top)
    kernels = sum(n for name, n in counts.items() if name not in VIEWS)
    print(f"mspg {cfg.N}^2 x {cfg.nl} {cfg.dtype}, one step on the CPU: "
          f"{len(top)} top-level torch operators, {kernels} not views")
    for name, n in counts.most_common(12):
        print(f"  {n:5d} {name}")


if __name__ == "__main__":
    main()
