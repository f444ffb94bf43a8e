#!/usr/bin/env python3
"""Time design variants of the y-profile solve's block-Thomas sweeps (KV)
on a CUDA card.

    python3 tools/kv_variants.py

Each variant is msom_tpu_torch/csrc/vary_sweep.cu with a few lines
replaced (SOURCES below) and a launch geometry (VARIANTS: the wrapper's,
with other columns, stage rows, ring bytes or route). The distinct
sources are built with the port's nvcc flags into build/kv_variants/ (all
builds started together, by tools/k1_variants.py's `build`) and launched
through the port's wrapper at tools/vary_bench.py's size, 2048^2 x 4 f32,
on block inverses drawn as chip_smoke.py's KV checks draw them
(`kv_problem`), in turns over two rounds, with CUDA events; each line
gives the lesser of the two times, its share of the byte bound and the
error against the plain version.

"one_warp" is the kernel's first design, its source copied into the
library (ONE_WARP): one thread a column with its nl-vector carry in
registers, 32-column one-warp blocks, a 16-row `cp.async` ring with no
barrier, the forward and the backward sweep as two launches. "copies" is
the shipped kernel with element copies in place of TMA, "two_launches"
one launch a sweep (TMA only), "cols16" and "cols32" other column blocks
(64- and 128-byte TMA box rows; stage rows by csrc's `rows_for` at that
many columns), "ring32k" and "ring96k" other ring sizes, "no_rotate" the
lanes' W planes in one order (4-way bank conflicts), "l2_none" no L2
promotion of the TMA requests. "loads_only" and "no_stores" compute
wrong values on purpose: they time the ring's copies and barriers alone,
and the sweeps without their stores. Prints the card's name and power
limit last.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import k1_variants  # noqa: E402
from msom_tpu_torch.solvers import fused_vary  # noqa: E402

OUT = ROOT / "build" / "kv_variants"

# The first design of KV, as it was written: one sweep a launch over
# 32-column blocks of one warp.
ONE_WARP = r'''
constexpr int BK = 32;                 // columns (threads) per block
constexpr int RING_BUDGET = 96 * 1024; // bytes of shared memory for the ring

// Ring depth in rows for a type and nl: as many as fit the budget, 2 to 16.
template <typename T, int NL>
__host__ __device__ constexpr int ring_depth() {
  return RING_BUDGET / ((NL * NL + NL) * BK * (int)sizeof(T)) > 16
             ? 16
             : (RING_BUDGET / ((NL * NL + NL) * BK * (int)sizeof(T)) < 2
                    ? 2
                    : RING_BUDGET / ((NL * NL + NL) * BK * (int)sizeof(T)));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int NL, bool BWD>
__global__ void __launch_bounds__(BK)
    one_warp_kernel(const T* __restrict__ W, const T* __restrict__ rhs,
                    T* __restrict__ out, int N, int K, T a) {
  constexpr int NB = NL * NL;           // W planes
  constexpr int P = NB + NL;            // planes a row
  constexpr int D = ring_depth<T, NL>();
  extern __shared__ __align__(16) unsigned char one_warp_smem[];
  T* ring = reinterpret_cast<T*>(one_warp_smem);   // [D][P][BK]
  const int t = threadIdx.x;
  const int k = blockIdx.x * BK + t;
  const bool live = k < K;
  const size_t NK = (size_t)N * K;

  auto issue = [&](int s) {
    if (live && s < N) {
      const int j = BWD ? N - 1 - s : s;
      const size_t off = (size_t)j * K + k;
      T* slot = ring + (size_t)(s % D) * P * BK + t;
#pragma unroll
      for (int p = 0; p < NB; ++p) cp_async(slot + p * BK, W + p * NK + off);
#pragma unroll
      for (int l = 0; l < NL; ++l)
        cp_async(slot + (NB + l) * BK, rhs + l * NK + off);
    }
    cp_async_commit();
  };

#pragma unroll 1
  for (int s = 0; s < D - 1; ++s) issue(s);

  T carry[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l) carry[l] = T(0);

#pragma unroll 1
  for (int s = 0; s < N; ++s) {
    issue(s + D - 1);
    cp_async_wait<D - 1>();
    if (live) {
      const T* slot = ring + (size_t)(s % D) * P * BK + t;
      T w[NB], r[NL], y[NL];
#pragma unroll
      for (int p = 0; p < NB; ++p) w[p] = slot[p * BK];
#pragma unroll
      for (int l = 0; l < NL; ++l) r[l] = slot[(NB + l) * BK];
      if (!BWD) {
        T v[NL];
#pragma unroll
        for (int b = 0; b < NL; ++b) v[b] = r[b] - a * carry[b];
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          T acc = T(0);
#pragma unroll
          for (int b = 0; b < NL; ++b) acc += w[i * NL + b] * v[b];
          y[i] = acc;
        }
      } else {
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          T acc = T(0);
#pragma unroll
          for (int b = 0; b < NL; ++b) acc += w[i * NL + b] * carry[b];
          y[i] = r[i] - a * acc;
        }
      }
      const int j = BWD ? N - 1 - s : s;
      const size_t off = (size_t)j * K + k;
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        carry[l] = y[l];
        out[l * NK + off] = y[l];
      }
    }
  }
  cp_async_wait<0>();
}

template <typename T, int NL>
int one_warp_launch(const T* W, const T* X, T* Y, T* Psi, int N, int K, T a,
                    cudaStream_t s) {
  constexpr int P = NL * NL + NL;
  constexpr int D = ring_depth<T, NL>();
  const size_t smem = (size_t)D * P * BK * sizeof(T);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        one_warp_kernel<T, NL, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(one_warp_kernel<T, NL, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((K + BK - 1) / BK);
  one_warp_kernel<T, NL, false><<<grid, BK, smem, s>>>(W, X, Y, N, K, a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  one_warp_kernel<T, NL, true><<<grid, BK, smem, s>>>(W, Y, Psi, N, K, a);
  return (int)cudaGetLastError();
}

'''
LAUNCH = ("  sweep_kernel<T, NL, TMA><<<grid, threads, smem, s>>>"
          "(maps, args);\n  return (int)cudaGetLastError();")
ENCODER = "typedef CUresult (*EncodeTiled)("


def cols(n):
    return ("  return lanes_for(nl) == 2 ? 16 : 8;", f"  return {n};")


SOURCES = {
    "chain": [],
    "one_warp": [
        (ENCODER, ONE_WARP + ENCODER),
        (LAUNCH, "  return one_warp_launch<T, NL>(args.W, args.X, args.Y, "
                 "args.Psi, args.N,\n                              args.K, "
                 "args.a, s);")],
    # stages g0..g1-1 a launch: the forward, then the backward sweep
    "two_launches": [
        ("  int N, K, stages;\n};",
         "  int N, K, stages;\n  int first, last;\n};"),
        ("  const int G = (p.N + R - 1) / R;             // stages a sweep\n",
         "  const int G = (p.N + R - 1) / R;             // stages a sweep\n"
         "  const int g0 = p.first * G, g1 = (p.last + 1) * G;\n"),
        ("for (int g = 0; g < 2 * G; ++g)", "for (int g = g0; g < g1; ++g)"),
        ("g % p.stages", "(g - g0) % p.stages"),
        ("g / p.stages", "(g - g0) / p.stages"),
        ("if (g == G) mbar_wait(turn, 0);",
         "if (g == G && g0 < G) mbar_wait(turn, 0);"),
        (LAUNCH, "  for (int sweep = 0; sweep < 2; ++sweep) {\n"
                 "    Args<T> one = args;\n"
                 "    one.first = one.last = sweep;\n"
                 "    sweep_kernel<T, NL, TMA><<<grid, threads, smem, s>>>"
                 "(maps, one);\n"
                 "    const cudaError_t e = cudaGetLastError();\n"
                 "    if (e != cudaSuccess) return (int)e;\n"
                 "  }\n  return 0;")],
    "cols16": [cols(16)],
    "cols32": [cols(32)],
    "no_rotate": [("src[bb] = (bb + i) % NL;", "src[bb] = bb;")],
    "l2_none": [("CU_TENSOR_MAP_L2_PROMOTION_L2_256B",
                 "CU_TENSOR_MAP_L2_PROMOTION_NONE")],
    "loads_only": [("    if (bwd)\n      stage_rows<T, NL, R, true>(",
                    "    if (j0 < -(1 << 30))\n"
                    "      stage_rows<T, NL, R, true>("),
                   ("    else\n      stage_rows<T, NL, R, false>(",
                    "    else if (j0 < -(1 << 30))\n"
                    "      stage_rows<T, NL, R, false>(")],
    "no_stores": [("    if (live && lane < NL && j >= 0 && j < N)",
                   "    if (live && j < -(1 << 30))")],
}
# name: (source, geometry changes: cols with its stage rows, ring bytes,
# route)
VARIANTS = {
    "chain": ("chain", {}),
    "one_warp": ("one_warp", dict(tma=False)),
    "copies": ("chain", dict(tma=False)),
    "two_launches": ("two_launches", {}),
    "cols16": ("cols16", dict(cols=16, rows=11, ring=128 * 1024)),
    "cols32": ("cols32", dict(cols=32, rows=5, ring=200 * 1024)),
    "ring32k": ("chain", dict(ring=32 * 1024)),
    "ring96k": ("chain", dict(ring=96 * 1024)),
    "no_rotate": ("no_rotate", {}),
    "l2_none": ("l2_none", {}),
    "loads_only": ("loads_only", {}),
    "no_stores": ("no_stores", {}),
}


def variant_geometry(nl, N, cols=None, rows=None, ring=None, tma=True):
    """The wrapper's geometry at N^2 x nl f32 with `cols` columns of `rows`
    stage rows, the stages that fit `ring` bytes, and element copies
    unless `tma`; the launch refuses it if the variant's source was not
    built for it."""
    g = fused_vary.geometry(nl, N, N, 4)
    if cols is not None:
        g = dataclasses.replace(g, cols=cols, rows=rows, grid=-(-N // cols),
                                threads=cols * g.lanes + 32)
    stages = g.stages if ring is None else min(
        fused_vary.MAX_STAGES,
        ring // fused_vary.stage_bytes(nl, 4, g.cols, g.rows))
    return dataclasses.replace(
        g, stages=stages, tma=g.tma and tma,
        smem=fused_vary.smem_bytes(nl, 4, g.cols, g.rows, stages))


def main():
    if not torch.cuda.is_available():
        print("kv_variants: no CUDA device", file=sys.stderr)
        return 1
    libs = {name: k1_variants.bound(lib, fused_vary)
            for name, lib in k1_variants.build(
                fused_vary.SOURCE, SOURCES, OUT).items()}
    N, nl = 2048, 4
    W, X, a = cs.kv_problem(N, N, nl, "float32")
    ref = fused_vary.sweep_reference(W, X, a)
    scale = ref.abs().max().item()
    t_bytes = cs.roofline(*fused_vary.bound_work(nl, N, N, 4), 4)[2]
    geoms = {name: variant_geometry(nl, N, **kw)
             for name, (_, kw) in VARIANTS.items()}
    assert geoms["two_launches"].tma
    times, errs = {}, {}
    for _ in range(2):
        for name, (src, _) in VARIANTS.items():
            fused_vary._lib = lambda lib=libs[src]: lib
            g = geoms[name]

            def run():
                return fused_vary.sweep(W, X, a, g)

            errs[name] = (run() - ref).abs().max().item() / scale
            for _ in range(3):
                run()
            times.setdefault(name, []).append(cs.cuda_ms(run, 50))
    read = cs.cuda_ms(lambda: W.sum(), 20)
    print(f"W.sum() (one read of W, {W.numel() * 4} B): {read:.4f} ms, "
          f"{W.numel() * 4 / read / 1e9:.3f} TB/s")
    for name, g in geoms.items():
        t = times[name]
        shape = ("32 columns x 1 lane, element copies, two launches"
                 if name == "one_warp" else
                 f"{g.cols} columns x {g.lanes} lanes, {g.rows} rows x "
                 f"{g.stages} stages, {'TMA' if g.tma else 'copies'}")
        print(f"KV {N}^2 x {nl} f32 {name} ({shape}): {min(t):.4f} ms "
              f"(rounds {', '.join(f'{x:.4f}' for x in t)}), "
              f"{t_bytes / min(t):.3f} of the byte bound, error "
              f"{errs[name]:.2e} of max|psi|")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
