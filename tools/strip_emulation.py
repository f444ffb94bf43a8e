#!/usr/bin/env python3
"""Run the fused tracer kernel (K2, msom_tpu_torch/csrc/fused_tracer.cu) on
the CPU, in a host emulation of its block, against the port's plain version.

    python3 tools/strip_emulation.py [--tsan]

The .cu is compiled by g++ after its CUDA builtins are swapped for the
PRELUDE below: a block's threads are `std::thread`s, `__syncthreads` is a
`std::barrier`, and a `cp.async` copy lands either at the wait that retires
its group ("late", which shows a row read before its wait) or at its issue
("early", which shows a ring slot overwritten while a step still reads it).
A copy on the card lands somewhere between the two. Each build is the
kernel's source with a few lines replaced (`ring` sets its ring rows R), and
is called through the same C entry as on the card, with the wrapper's
`launch_geometry`, on numpy arrays; each line gives the worst error over
the cases, walled and doubly periodic, in f64 and f32, as a share of its
limit (1e-11, 1e-4 of max|dtr|). The kernel's ring needs DEPTH + 3 = 6 rows: the script runs the
shipped ring, 6 and 5, and 5 must go wrong. `--tsan` also builds each ring
with ThreadSanitizer, its copies landing early, into a program that runs
the cases and prints how many races it reported (a copy into a slot that
another thread reads in the same step is one). Last it runs the rows mode
on virtual shards against the plain rows version (`rows_worst_error`).
Builds go to build/strip_emulation/.
"""

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from msom_tpu_torch.models import fused_tracer, qg  # noqa: E402
from msom_tpu_torch.params import QGConfig  # noqa: E402

OUT = ROOT / "build" / "strip_emulation"
LIMITS = {"float64": 1e-11, "float32": 1e-4}
# (N, nl, nptr): one strip with all four walls; partial strips with 16-byte
# copies and the run-time nptr; one-column and one-row strips with
# one-element copies
CASES = [(48, 2, 2), (130, 2, 3), (257, 1, 2)]

PRELUDE = r"""
#include <barrier>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(x) alignas(x)
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 0 };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx, gridDim;
inline thread_local std::barrier<>* emu_bar = nullptr;
inline thread_local unsigned char* emu_smem = nullptr;
inline void __syncthreads() { emu_bar->arrive_and_wait(); }
template <class K> int cudaFuncSetAttribute(K, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int) { return "host emulation"; }
template <class T> T min(T a, T b) { return a < b ? a : b; }
template <class T> T emu_ldcs(const T* p) { return *p; }
struct Copy { void* d; const void* s; int n; };
inline thread_local std::vector<std::vector<Copy>> emu_groups;
inline thread_local std::vector<Copy> emu_open;
inline void emu_cp_async(void* d, const void* s, int n) {
#ifdef EMU_EARLY
  std::memcpy(d, s, n);
#else
  emu_open.push_back({d, s, n});
#endif
}
inline void emu_commit() { emu_groups.push_back(emu_open); emu_open.clear(); }
inline void emu_wait(int pending) {
  while ((int)emu_groups.size() > pending) {
    for (auto& c : emu_groups.front()) std::memcpy(c.d, c.s, c.n);
    emu_groups.erase(emu_groups.begin());
  }
}
// the blocks one after another, each block's threads together; shared
// memory starts as NaN bytes, so a read of a row never written shows
template <class K, class... A>
void emu_launch(K kernel, dim3 grid, dim3 block, size_t smem, A... args) {
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::vector<unsigned char> sm(smem + 16, 0xff);
        std::barrier<> bar(block.x);
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < block.x; ++t)
          ts.emplace_back([&, t] {
            threadIdx = dim3(t);
            blockIdx = dim3(bx, by, bz);
            gridDim = grid;
            emu_bar = &bar;
            emu_smem = sm.data();
            emu_groups.clear();
            emu_open.clear();
            kernel(args...);
            emu_wait(0);
          });
        for (auto& th : ts) th.join();
      }
}
"""

# a program that runs the cases once in each type, for ThreadSanitizer
TSAN_MAIN = r"""
#include <vector>
extern "C" int fused_tracer_f32(const void*, const void*, const void*, void*,
    int, int, int, double, const double*, const double*, int, int, int,
    long long, int, int, int, int, void*);
extern "C" int fused_tracer_f64(const void*, const void*, const void*, void*,
    int, int, int, double, const double*, const double*, int, int, int,
    long long, int, int, int, int, void*);
template <class T>
int run(int (*fn)(const void*, const void*, const void*, void*, int, int,
                  int, double, const double*, const double*, int, int, int,
                  long long, int, int, int, int, void*),
        int N, int nl, int nptr, int rows, int gx, int gy, long long smem,
        int periodic) {
  const size_t n = (size_t)nl * nptr * N * N;
  std::vector<T> psi((size_t)nl * N * N), tr(n), relax(n), out(n);
  for (size_t i = 0; i < psi.size(); ++i) psi[i] = T((i * 7919 % 101) - 50);
  for (size_t i = 0; i < n; ++i) tr[i] = T((i * 104729 % 97) - 48);
  double iPe[16], ir[16];
  for (int j = 0; j < 16; ++j) { iPe[j] = 1e-3 * (j + 1); ir[j] = 1e-2; }
  return fn(psi.data(), tr.data(), relax.data(), out.data(), N, nl, nptr,
            0.1, iPe, ir, rows, gx, gy, smem, periodic, 0, N, 0, nullptr);
}
int main() {
  int rc = 0;
  CASE_CALLS
  return rc;
}
"""


def translate(src: str, patches=()) -> str:
    """The .cu as host C++ for the emulation, with `patches` (text, new
    text) applied first."""
    for a, b in patches:
        if a not in src:
            raise ValueError(f"strip_emulation: {a!r} is not in the source")
        src = src.replace(a, b)
    subs = [("#include <cuda_runtime.h>", PRELUDE + "#include <cmath>\n"),
            ("extern __shared__ __align__(16) unsigned char smem_raw[];",
             "unsigned char* smem_raw = emu_smem;")]
    for a, b in subs:
        if a not in src:
            raise ValueError(f"strip_emulation: {a!r} is not in the source")
        src = src.replace(a, b)
    # the cached loads, where a kernel has them
    src = src.replace("__ldcs(", "emu_ldcs(").replace("__ldg(", "emu_ldcs(")
    bodies = [
        (r"(void cp_async\(void\* dst, const void\* src\) \{).*?\n\}",
         r"\1\n  emu_cp_async(dst, src, BYTES);\n}"),
        (r"(void cp_async_commit\(\) \{).*?\n\}", r"\1 emu_commit(); }"),
        (r"(void cp_async_wait\(\) \{).*?\n\}", r"\1 emu_wait(PENDING); }"),
        (r"(\w+)<<<grid, block, smem, .*?>>>\((.*?)\);",
         r"emu_launch(\1, grid, block, smem, \2);"),
    ]
    for pat, rep in bodies:
        src, n = re.subn(pat, rep, src, flags=re.S)
        if n != 1:
            raise ValueError(f"strip_emulation: {pat!r} matched {n} times")
    return src


def ring_patch(ring: int):
    """A ring of `ring` rows, the kernel's check of the rule lifted."""
    return [("constexpr int R = 8;", f"constexpr int R = {ring};"),
            ("static_assert(R >= DEPTH + 3,", "static_assert(true,")]


def build(name: str, patches=(), early=False, tsan=False, out=OUT,
          source=fused_tracer.SOURCE) -> Path:
    """Compile the translated kernel `source` (a path in the repo) into
    out/<name>.so (or, with tsan, a ThreadSanitizer program out/<name> that
    runs K2's CASES)."""
    out.mkdir(parents=True, exist_ok=True)
    src = translate((ROOT / source).read_text(), patches)
    cpp = out / f"{name}.cpp"
    flags = ["g++", "-std=c++20", "-O1", "-pthread", "-w"]
    flags += ["-DEMU_EARLY"] if early else []
    if tsan:
        calls = []
        for N, nl, nptr in CASES:
            for T, size in (("float", 4), ("double", 8)):
                (gx, gy, _), _, smem = fused_tracer.launch_geometry(
                    N, nl, nptr, size)
                fn = "fused_tracer_f32" if size == 4 else "fused_tracer_f64"
                for periodic in (0, 1):
                    calls.append(f"rc |= run<{T}>({fn}, {N}, {nl}, {nptr}, "
                                 f"{fused_tracer.SY}, {gx}, {gy}, {smem}, "
                                 f"{periodic});")
        main = TSAN_MAIN.replace("CASE_CALLS", "\n  ".join(calls))
        cpp.write_text(src + main)
        target = out / name
        flags += ["-g", "-fsanitize=thread", str(cpp), "-o", str(target)]
    else:
        cpp.write_text(src)
        target = out / f"{name}.so"
        flags += ["-shared", "-fPIC", str(cpp), "-o", str(target)]
    subprocess.run(flags, check=True, timeout=600)
    return target


def _config(N, nl, nptr, dtype, periodic=False):
    return QGConfig(N=N, nl=nl, L0=80, Rom=0.025, Ekb=0.002, Eks=0.001,
                    sbc=-1.0 if periodic else 0.0,
                    tau0=1e-4, Re4=391, beta=0.5, Fr=(0.003,) * (nl - 1),
                    dh=(1.0 / nl,) * nl, DT=5e-2, tend=1e9, dtout=1e9,
                    CFL=0.6, dtype=dtype, solver="spectral", nptr=nptr,
                    Pe=tuple(1e3 * (1 + j) for j in range(nptr)),
                    ptr_r=tuple(0.0 if j == 1 else 100.0 / (1 + j)
                                for j in range(nptr))).validate()


def _load(lib_path: Path):
    lib = ctypes.CDLL(str(lib_path))
    for fn in (lib.fused_tracer_f32, lib.fused_tracer_f64):
        fn.argtypes = fused_tracer.ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def worst_error(lib_path: Path, cases=CASES, periodic=(False, True)) -> float:
    """The largest error of the emulated kernel against the plain version
    over `cases`, walled and periodic, f64 and f32, relaxation field on and
    off, as a share of its limit (above 1: wrong)."""
    lib = _load(lib_path)
    worst = 0.0
    for dtype, per in ((d, p) for d in ("float64", "float32")
                       for p in periodic):
        npt = np.dtype(dtype)
        for N, nl, nptr in cases:
            for relax_on in (False, True):
                cfg = _config(N, nl, nptr, dtype, per)
                rng = np.random.default_rng(N * 7 + nl * 3 + nptr)
                psi = (1e-3 * rng.uniform(-1, 1, (nl, N, N))).astype(npt)
                tr = rng.uniform(-1, 1, (nl, nptr, N, N)).astype(npt)
                relax = (rng.uniform(-1, 1, tr.shape).astype(npt)
                         if relax_on else None)
                const = qg.build_constants(cfg, device="cpu",
                                           ptr_relax=relax)
                ref = fused_tracer.tracer_fused_reference(
                    cfg, const, torch.as_tensor(psi),
                    torch.as_tensor(tr)).numpy()
                out = np.full_like(tr, np.nan)
                (gx, gy, _), _, smem = fused_tracer.launch_geometry(
                    N, nl, nptr, npt.itemsize)
                fn = (lib.fused_tracer_f64 if dtype == "float64"
                      else lib.fused_tracer_f32)
                arr = ctypes.c_double * nptr
                rc = fn(psi.ctypes.data, tr.ctypes.data,
                        None if relax is None else relax.ctypes.data,
                        out.ctypes.data, N, nl, nptr, cfg.delta,
                        arr(*cfg.iPe[:nptr]), arr(*cfg.ptr_ir[:nptr]),
                        fused_tracer.SY, gx, gy, smem, int(per), 0, N, 0,
                        None)
                if rc != 0:
                    raise RuntimeError(f"strip_emulation: launch refused "
                                       f"({rc}) at N = {N}")
                err = float(np.abs(out - ref).max() / np.abs(ref).max())
                # a NaN (a ring cell never written) is as wrong as can be
                worst = max(worst, err / LIMITS[dtype]
                            if np.isfinite(err) else np.inf)
    return worst


# (N, nl, nptr, shards) of the rows mode: shards of 24 rows (one partial
# strip) and of 16
ROWS_CASES = [(48, 2, 2, 2), (64, 1, 3, 4)]
# the rows mode's build (csrc/fused_tracer_rows.cu): the source with its
# rows constant on
ROWS = [("#include <cuda_runtime.h>",
         "#define FUSED_TRACER_ROWS 1\n#include <cuda_runtime.h>")]


def rows_worst_error(lib_path: Path, cases=ROWS_CASES,
                     periodic=(False, True)) -> float:
    """The emulated rows kernel (built with the ROWS patch) on virtual
    shards (each shard's launch with its halo slabs cut from the whole
    field,
    parallel/halo.split_rows8) against the plain rows version, walled and
    periodic, f64 and f32, the relaxation field on; the largest error as a
    share of its limit."""
    from msom_tpu_torch.parallel import halo
    lib = _load(lib_path)
    worst = 0.0
    for dtype, per in ((d, p) for d in ("float64", "float32")
                       for p in periodic):
        npt = np.dtype(dtype)
        for N, nl, nptr, W in cases:
            cfg = _config(N, nl, nptr, dtype, per)
            rng = np.random.default_rng(N + nl + W)
            psi = torch.as_tensor(
                (1e-3 * rng.uniform(-1, 1, (nl, N, N))).astype(npt))
            tr = torch.as_tensor(
                rng.uniform(-1, 1, (nl, nptr, N, N)).astype(npt))
            const = qg.build_constants(
                cfg, device="cpu",
                ptr_relax=rng.uniform(-1, 1, tr.shape).astype(npt))
            n = N // W
            p_ext = halo.split_rows8(psi, W, per)
            t_ext = halo.split_rows8(tr.reshape(nl * nptr, N, N), W, per)
            (gx, gy, _), _, smem = fused_tracer.launch_geometry(
                N, nl, nptr, npt.itemsize, n)
            fn = (lib.fused_tracer_f64 if dtype == "float64"
                  else lib.fused_tracer_f32)
            arr = ctypes.c_double * nptr
            for d in range(W):
                rows = slice(d * n, (d + 1) * n)
                ref = fused_tracer.tracer_fused_reference(
                    cfg, const, psi[:, rows], tr[..., rows, :],
                    psi_ext=p_ext[d], tr_ext=t_ext[d], row0=d * n)
                out = torch.full_like(ref, float("nan"))
                rc = fn(p_ext[d].data_ptr(), t_ext[d].data_ptr(),
                        const.ptr_relax.data_ptr(), out.data_ptr(), N, nl,
                        nptr, cfg.delta, arr(*cfg.iPe[:nptr]),
                        arr(*cfg.ptr_ir[:nptr]), fused_tracer.SY, gx, gy,
                        smem, int(per), d * n, n, 1, None)
                if rc != 0:
                    raise RuntimeError(f"strip_emulation: rows launch "
                                       f"refused ({rc}) at N = {N}")
                err = ((out - ref).abs().max() / ref.abs().max()).item()
                worst = max(worst, err / LIMITS[dtype]
                            if np.isfinite(err) else np.inf)
    return worst


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tsan", action="store_true",
                    help="also run each ring under ThreadSanitizer")
    args = ap.parse_args()
    wrong = {}
    for ring in (fused_tracer.RING, 6, 5):
        for early in (False, True):
            mode = "early" if early else "late"
            lib = build(f"ring{ring}_{mode}", ring_patch(ring), early)
            w = worst_error(lib)
            wrong[ring, mode] = not w <= 1.0
            print(f"ring {ring}, copies land {mode}: worst error "
                  f"{w:.3e} of the limit, {'WRONG' if w > 1 else 'right'}",
                  flush=True)
        if args.tsan:
            prog = build(f"ring{ring}_tsan", ring_patch(ring), early=True,
                         tsan=True)
            run = subprocess.run([str(prog)], capture_output=True, text=True,
                                 timeout=1800)
            races = run.stderr.count("WARNING: ThreadSanitizer: data race")
            print(f"ring {ring}, ThreadSanitizer: {races} race reports, "
                  f"exit {run.returncode}", flush=True)
    # the shipped ring and the rule's 6 right, 5 wrong
    ok = (not any(wrong[r, m] for r in (fused_tracer.RING, 6)
                  for m in ("late", "early"))
          and (wrong[5, "late"] or wrong[5, "early"]))
    print("ring sizes as the rule says" if ok else "ring rule NOT shown")
    w = rows_worst_error(build("rows", ROWS))
    print(f"rows mode on virtual shards: worst error {w:.3e} of the limit, "
          f"{'WRONG' if w > 1 else 'right'}")
    return 0 if ok and w <= 1 else 1


if __name__ == "__main__":
    sys.exit(main())
