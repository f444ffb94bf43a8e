#!/usr/bin/env python3
"""Time design variants of the fused qg-node tendency (K5) on a CUDA card.

    python3 tools/k5_variants.py

Each variant is msom_tpu_torch/csrc/node_rhs.cu with a few lines replaced
(VARIANTS below), built with the port's nvcc flags into build/k5_variants/
(all builds started together, by tools/k1_variants.py's `build`) and
launched through the port's wrapper at bench.py's node configuration,
2048^2 x 4 f32 (chip_smoke.py's `node_config`, its noise IC), in turns over
two rounds, with CUDA events; each line gives the lesser of the two times,
its share of the byte bound and the error against the plain version.
"no_walls" and "loads_only" compute wrong values on purpose: they time what
is left without the wall code, and the march's copies, masking and barriers
alone. "copy8" and "copy16" copy the raw rows 8 and 16 bytes at a time.
Prints the card's name and power limit last.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import k1_variants  # noqa: E402
from msom_tpu_torch.models import fused_node_rhs, qg_node  # noqa: E402

OUT = ROOT / "build" / "k5_variants"
VARIANTS = {
    "strip": [],
    "runtime_nl": [("  if (nl == 4)\n", "  if (nl == -1)\n")],
    "sy64": [("constexpr int SY = 32;", "constexpr int SY = 64;")],
    "no_walls": [("  const bool edge = x0 <= 2 || x0 + TX + 1 >= M - 1 "
                  "|| y0 <= 2\n                 || y1 + 1 >= M - 1;",
                  "  const bool edge = false;")],
    "loads_only": [
        ("if (s <= y1 + 1 && s >= 0 && s < M) zeta_row(s);",
         "if (s < -M) zeta_row(s);"),
        ("if (t >= y0 - 1 && t <= y1 && t >= 0 && t < M) tmp_row(t);",
         "if (t < -M) tmp_row(t);"),
        ("if (g >= y0 && g < y1) {", "if (g < -M) {")],
    "copy8": [("constexpr int COPY_BYTES = 4;",
               "constexpr int COPY_BYTES = 8;")],
    "copy16": [("constexpr int COPY_BYTES = 4;",
                "constexpr int COPY_BYTES = 16;")],
}


def main():
    if not torch.cuda.is_available():
        print("k5_variants: no CUDA device", file=sys.stderr)
        return 1
    libs = {name: k1_variants.bound(lib, fused_node_rhs)
            for name, lib in k1_variants.build(
                fused_node_rhs.SOURCE, VARIANTS, OUT).items()}
    N, nl = 2048, 4
    cfg = cs.node_config(qg_node.NodeQGConfig, N, nl, "float32")
    const = qg_node.build_constants(cfg, device="cuda")
    psi = torch.as_tensor(cs.node_noise_ic(cfg), dtype=torch.float32,
                          device="cuda")
    q = qg_node.comp_q(cfg, const, psi)
    qf = qg_node.q_forcing_profile(cfg, const.yv[:, 0],
                                   torch.tensor(0.37, device="cuda"))
    ref = fused_node_rhs.rhs_node_reference(cfg, const, q, psi, qf)
    scale = ref.abs().max().item()
    t_bytes = cs.roofline(*fused_node_rhs.bound_work(cfg, const, 4), 4)[2]
    times, errs = {}, {}
    for _ in range(2):
        for name, lib in libs.items():
            fused_node_rhs._lib = lambda lib=lib: lib

            def run():
                return fused_node_rhs.rhs_fused_node(cfg, const, q, psi, qf)

            errs[name] = (run() - ref).abs().max().item() / scale
            for _ in range(5):
                run()
            times.setdefault(name, []).append(cs.cuda_ms(run, 100))
    for name in libs:
        t = times[name]
        print(f"node {N}^2 x {nl} f32 {name}: {min(t):.4f} ms (rounds "
              f"{', '.join(f'{x:.4f}' for x in t)}), {t_bytes / min(t):.3f} "
              f"of the byte bound, error {errs[name]:.2e} of max|dq|")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
