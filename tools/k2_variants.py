#!/usr/bin/env python3
"""Time design variants of the fused tracer tendency (K2) on a CUDA card.

    python3 tools/k2_variants.py

Each variant is msom_tpu_torch/csrc/fused_tracer.cu with a few lines
replaced (VARIANTS below), built with the port's nvcc flags into
build/k2_variants/ (all builds started together, by tools/k1_variants.py's
`build`) and launched through the port's wrapper at bench.py's coupled
configuration, 2048^2 x 4 f32 with two tracers (chip_smoke.py's
`bench_config` and `TRACERS`), in turns over two rounds, with CUDA events;
each line gives the lesser of the two times, its share of the byte bound
and the error against the plain version. "runtime_nptr" runs the loop over
a run-time tracer count in place of the nptr = 2 template case, "copy4"
4-byte copies in place of 16-byte ones, "ring6" the rule's least ring in
place of 8 rows; the ROWS variants run the strip library on strips of
other heights (the wrapper's `SY`, which the launch takes). "no_walls" and
"loads_only" compute wrong values on purpose: they time what is left
without the wall code, and the march's copies and barriers alone. Prints
the card's name and power limit last.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import k1_variants  # noqa: E402
from msom_tpu_torch.models import fused_tracer, qg  # noqa: E402
from msom_tpu_torch.params import QGConfig  # noqa: E402

OUT = ROOT / "build" / "k2_variants"
VARIANTS = {
    "strip": [],
    "runtime_nptr": [("  if (nptr == 2) return run",
                      "  if (nptr == -1) return run")],
    "depth2": [("constexpr int DEPTH = 3;", "constexpr int DEPTH = 2;")],
    "depth4": [("constexpr int DEPTH = 3;", "constexpr int DEPTH = 4;")],
    "ring6": [("constexpr int R = 8;", "constexpr int R = 6;")],
    "copy4": [("  p.vec = N % (16 / (int)sizeof(T)) == 0",
               "  p.vec = false && N % (16 / (int)sizeof(T)) == 0")],
    "one_path": [("march<T, NPT, false>(", "march<T, NPT, true>(")],
    "no_walls": [("  if (edge)\n    march<T, NPT, true>",
                  "  if (false)\n    march<T, NPT, true>")],
    "loads_only": [
        ("    // the outputs of row s, all tracers of the layer\n",
         "    if (s < -N) {\n"),
        ("    // row s + 2, read from the next step on, has landed",
         "    }\n    // row s + 2")],
    "no_stores": [("      if (gx < N) {\n#pragma unroll",
                   "      if (gx < N && res[0] == T(-7.5e-31)) {\n"
                   "#pragma unroll")],
    "no_math": [("        res[j] = mjac(pn, cn, i12d2) + p.iPe[j] * lap "
                 "+ p.ir[j] * tgt;", "        res[j] = cc;")],
    "lb8": [("__global__ void __launch_bounds__(NTH)\ntracer_kernel",
             "__global__ void __launch_bounds__(NTH, 8)\ntracer_kernel")],
    "stcs": [("          F.dtr[((size_t)l * NPT + j) * NN + row] = res[j];",
              "          __stcs(F.dtr + ((size_t)l * NPT + j) * NN + row, "
              "res[j]);")],
}
# strip heights, on the strip library (sy147: one wave of blocks)
ROWS = {"sy16": 16, "sy64": 64, "sy147": 147}


def main():
    if not torch.cuda.is_available():
        print("k2_variants: no CUDA device", file=sys.stderr)
        return 1
    libs = {name: k1_variants.bound(lib, fused_tracer)
            for name, lib in k1_variants.build(
                fused_tracer.SOURCE, VARIANTS, OUT).items()}
    N, nl = 2048, 4
    cfg = cs.bench_config(QGConfig, N, nl, "float32", **cs.TRACERS)
    const = qg.build_constants(cfg, device="cuda", **cs.coupled_fields(cfg))
    rng = np.random.default_rng(0)
    psi = torch.as_tensor(1e-3 * rng.uniform(-1, 1, (nl, N, N)),
                          dtype=torch.float32, device="cuda")
    tr = torch.as_tensor(1e-3 * rng.uniform(-1, 1, (nl, cfg.nptr, N, N)),
                         dtype=torch.float32, device="cuda")
    ref = fused_tracer.tracer_fused_reference(cfg, const, psi, tr)
    scale = ref.abs().max().item()
    t_bytes = cs.roofline(*fused_tracer.bound_work(cfg, const, 4), 4)[2]
    times, errs = {}, {}
    sy = fused_tracer.SY
    for _ in range(2):
        for name in [*libs, *ROWS]:
            lib = libs.get(name, libs["strip"])
            fused_tracer._lib = lambda lib=lib: lib
            fused_tracer.SY = ROWS.get(name, sy)

            def run():
                return fused_tracer.tracer_fused(cfg, const, psi, tr)

            errs[name] = (run() - ref).abs().max().item() / scale
            for _ in range(5):
                run()
            times.setdefault(name, []).append(cs.cuda_ms(run, 100))
    fused_tracer.SY = sy
    for name in times:
        t = times[name]
        print(f"coupled {N}^2 x {nl} x {cfg.nptr} f32 {name}: {min(t):.4f} ms "
              f"(rounds {', '.join(f'{x:.4f}' for x in t)}), "
              f"{t_bytes / min(t):.3f} of the byte bound, error "
              f"{errs[name]:.2e} of max|dtr|")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
