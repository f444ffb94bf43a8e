#!/usr/bin/env python3
"""Time design variants of the fused msqg tendency (K1) on a CUDA card.

    python3 tools/k1_variants.py

Each variant is msom_tpu_torch/csrc/fused_rhs.cu with a few lines replaced
(VARIANTS below), built with the port's nvcc flags into build/k1_variants/
(all builds started together) and launched through the port's wrapper at
chip_smoke.py's 2048^2 x 4 f32 shapes, uncoupled and coupled (pp and
topography), in turns over two rounds, with CUDA events; each line gives
the lesser of the two times and the error against the plain version.
"no_walls" and "loads_only" compute wrong values on purpose: they time what
is left without the wall code, and the march's copies and barriers alone.
Prints the card's name and power limit last.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from msom_tpu_torch import _build  # noqa: E402
from msom_tpu_torch.models import fused_rhs, qg  # noqa: E402
from msom_tpu_torch.params import QGConfig  # noqa: E402

OUT = ROOT / "build" / "k1_variants"
VARIANTS = {
    "strip": [],
    "runtime_nl": [("  if (nl == 4)\n", "  if (nl == -1)\n")],
    "sy64": [("constexpr int SY = 32;", "constexpr int SY = 64;")],
    "no_walls": [("  const bool edge = xwall || y0 <= 3 || y1 + 3 >= N;",
                  "  const bool edge = false;")],
    "loads_only": [
        ("if (s <= y1 + 1 && (PER || interior(s, N)))", "if (s < -N)"),
        ("if (t >= y0 - 1 && t <= y1 && (PER || interior(t, N))) {",
         "if (t < -N) {"),
        ("if (gy >= y0 && gy < y1 && gx < N) {", "if (gy < -N) {")],
}


def build(source=fused_rhs.SOURCE, variants=VARIANTS, out=OUT):
    """{name: library} of every variant of `source` (a path in the repo),
    built into `out`, with the nvcc register lines."""
    src = (ROOT / source).read_text()
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
               str(out / f"lib{name}.so"), str(cu)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        regs = [ln.split(":")[-1].strip() for ln in log.splitlines()
                if "registers" in ln]
        print(f"{name}: {'; '.join(regs)}")
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
    return libs


def bound(lib, module=fused_rhs):
    """The ctypes declarations of `module`'s wrapper (its cached `_lib`)
    made on another library."""
    load = _build.load
    _build.load = lambda name: lib
    try:
        return module._lib.__wrapped__()
    finally:
        _build.load = load


def main():
    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device", file=sys.stderr)
        return 1
    libs = {name: bound(lib) for name, lib in build().items()}
    N, nl = 2048, 4
    times = {}
    for label in ("uncoupled", "coupled"):
        coupled = label == "coupled"
        cfg = cs.bench_config(QGConfig, N, nl, "float32",
                              **(cs.TRACERS if coupled else {}))
        const = qg.build_constants(
            cfg, device="cuda", **(cs.coupled_fields(cfg) if coupled else {}))
        rng = np.random.default_rng(0)
        psi = torch.as_tensor(1e-3 * rng.uniform(-1, 1, (nl, N, N)),
                              dtype=torch.float32, device="cuda")
        dq_r, _ = fused_rhs.rhs_fused_reference(cfg, const, psi)
        scale = dq_r.abs().max().item()
        errs = {}
        for _ in range(2):
            for name, lib in libs.items():
                fused_rhs._lib = lambda lib=lib: lib

                def run():
                    return fused_rhs.rhs_fused(cfg, const, psi)

                dq, _ = run()
                errs[name] = (dq - dq_r).abs().max().item() / scale
                for _ in range(5):
                    run()
                times.setdefault((label, name), []).append(
                    cs.cuda_ms(run, 100))
        for name in libs:
            t = times[label, name]
            print(f"{label} {name}: {min(t):.4f} ms (rounds "
                  f"{', '.join(f'{x:.4f}' for x in t)}), error "
                  f"{errs[name]:.2e} of max|dq|")
        del const, psi, dq_r
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
