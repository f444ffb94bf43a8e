#!/usr/bin/env python3
"""Run the multigrid relaxation kernel (K3, msom_tpu_torch/csrc/mg_sweep.cu)
and the residual kernel (K4, csrc/mg_residual.cu) on the CPU, in a host
emulation of their blocks, against the port's plain versions.

    python3 tools/k3_emulation.py

The .cu is compiled by g++ after its CUDA builtins are swapped for the
PRELUDE below: a block's threads are fibers (ucontext) run in turns in one
process thread, `__syncthreads` hands over to the next fiber, so one round
of turns is one barrier phase; a `cp.async` copy lands at the wait that
retires its group ("late") or at its issue ("early", which shows a ring
slot overwritten while a step still reads it); shared memory starts as NaN
bytes, and the blocks run one after another (K4's ticket and last-block
reduction included). The threads take their turns first to last, or
last to first (`reverse`): a thread that reads what another writes in the
same step shows in one of the two. `fma_` becomes a product and a sum (g++ with
-ffp-contract=off), so the emulated K3 computes the plain version's
arithmetic term for term: a launch of k sweeps must equal k plain sweeps
(`fused_mg.relax_reference`) BIT FOR BIT, in f64 and f32, walled and
periodic_x; K4 must meet its limit (it multiplies by 1/delta^2 where the
plain version divides). The emulation takes the C library's own launch
rule with WAVE_SMS = 1, so that a strip is the tallest the rule allows (a
handful of blocks to emulate); `rows_patch` sets the strip height
instead. MUTATIONS are faults the checks must show: the ring one row short
(DEPTH one deeper), LAG = 2, the red reach one short, a wait one short, a
store one step early. Builds go to build/k3_emulation/ (or --out).
"""

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from msom_tpu_torch.solvers import fused_mg, mg  # noqa: E402

OUT = ROOT / "build" / "k3_emulation"
KMAX = 4                 # the strip's sweeps a launch (csrc/mg_sweep.cu)
# the CUDA builtins the kernels use, a block's threads as fibers
PRELUDE = r"""
#include <ucontext.h>
#include <cmath>
#include <cstring>
#include <functional>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 0 };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint4 { unsigned x, y, z, w; };
struct Copy { void* d; const void* s; int n; };
struct Fiber {
  ucontext_t ctx;
  std::vector<char> stack;
  dim3 tid;
  std::vector<std::vector<Copy>> groups;
  std::vector<Copy> open;
  bool done = false;
};
inline Fiber* emu_cur = nullptr;
inline ucontext_t emu_sched;
inline std::function<void()> emu_body;
inline dim3 blockIdx, gridDim;
inline unsigned char* emu_smem = nullptr;
#define threadIdx (emu_cur->tid)
inline void __syncthreads() { swapcontext(&emu_cur->ctx, &emu_sched); }
inline void __threadfence() {}
template <class T> T min(T a, T b) { return a < b ? a : b; }
template <class T> T max(T a, T b) { return a > b ? a : b; }
template <class T> T emu_ldg(const T* p) { return *p; }
inline float __fmaf_rn(float a, float b, float c) { return a * b + c; }
inline double __fma_rn(double a, double b, double c) { return a * b + c; }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  const unsigned old = *p;   // the blocks run one after another
  *p = old + v;
  return old;
}
template <class K> int cudaFuncSetAttribute(K, int, int) { return 0; }
template <class K>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return 0;
}
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int) { return "host emulation"; }
inline void emu_cp_async(void* d, const void* s, int n) {
#ifdef EMU_EARLY
  std::memcpy(d, s, n);
#else
  emu_cur->open.push_back({d, s, n});
#endif
}
inline void emu_commit() {
  emu_cur->groups.push_back(emu_cur->open);
  emu_cur->open.clear();
}
inline void emu_wait(int pending) {
  auto& g = emu_cur->groups;
  while ((int)g.size() > pending) {
    for (auto& c : g.front()) std::memcpy(c.d, c.s, c.n);
    g.erase(g.begin());
  }
}
inline void emu_fiber_main() {
  emu_body();
  emu_wait(0);
  emu_cur->done = true;
}
// the blocks one after another; a block's fibers in turns until all end
template <class K, class... A>
void emu_launch(K kernel, dim3 grid, dim3 block, size_t smem, A... args) {
  emu_body = [&] { kernel(args...); };
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::vector<unsigned char> sm(smem + 16, 0xff);
      emu_smem = sm.data();
      blockIdx = dim3(bx, by);
      gridDim = grid;
      std::vector<Fiber> fs(block.x);
      for (unsigned t = 0; t < block.x; ++t) {
        Fiber& f = fs[t];
        f.tid = dim3(t);
        f.stack.resize(256 * 1024);
        getcontext(&f.ctx);
        f.ctx.uc_stack.ss_sp = f.stack.data();
        f.ctx.uc_stack.ss_size = f.stack.size();
        f.ctx.uc_link = &emu_sched;
        makecontext(&f.ctx, emu_fiber_main, 0);
      }
      for (bool left = true; left;) {
        left = false;
        for (unsigned i = 0; i < block.x; ++i) {
#ifdef EMU_REVERSE
          Fiber& f = fs[block.x - 1 - i];
#else
          Fiber& f = fs[i];
#endif
          if (f.done) continue;
          emu_cur = &f;
          swapcontext(&emu_sched, &f.ctx);
          left |= !f.done;
        }
      }
    }
}
"""
LAUNCHES = {
    "mg_sweep": [
        ("kernel<<<grid, G::NTH, strip_smem<T, NL>(p.rows), stream>>>(p);",
         "emu_launch(kernel, grid, dim3(G::NTH), "
         "strip_smem<T, NL>(p.rows), p);"),
        ("mg_whole_kernel<T, NL><<<1, WHOLE_NTH, smem, stream>>>(p);",
         "emu_launch(mg_whole_kernel<T, NL>, dim3(1), dim3(WHOLE_NTH), smem, "
         "p);"),
        ("constexpr int WAVE_SMS = 132;", "constexpr int WAVE_SMS = 1;")],
    "mg_residual": [
        ("mg_residual_kernel<T, NL, PX><<<grid, NTH, smem, stream>>>(p);",
         "emu_launch(mg_residual_kernel<T, NL, PX>, grid, dim3(NTH), smem, "
         "p);")],
}


def translate(src: str, patches) -> str:
    """The .cu as host C++, with `patches` (text, new text) applied."""
    for a, b in patches:
        if a not in src:
            raise ValueError(f"k3_emulation: {a!r} is not in the source")
        src = src.replace(a, b)
    for a, b in [("#include <cuda_runtime.h>", PRELUDE),
                 ("extern __shared__ __align__(16) unsigned char "
                  "smem_raw[];", "unsigned char* smem_raw = emu_smem;")]:
        if a not in src:
            raise ValueError(f"k3_emulation: {a!r} is not in the source")
        src = src.replace(a, b)
    src = src.replace("__ldg(", "emu_ldg(")
    for pat, rep in [
            (r"(void cp_async\(void\* dst, const void\* src\) \{).*?\n\}",
             r"\1\n  emu_cp_async(dst, src, BYTES);\n}"),
            (r"(void cp_async_commit\(\) \{).*?\n\}", r"\1 emu_commit(); }"),
            (r"(void cp_async_wait\(\) \{).*?\n\}",
             r"\1 emu_wait(PENDING); }")]:
        src, n = re.subn(pat, rep, src, flags=re.S)
        if n > 1:
            raise ValueError(f"k3_emulation: {pat!r} matched {n} times")
    # a prefetch, where a kernel has one, does nothing here
    return re.sub(r"(void prefetch_l2\(const void\* p\) \{).*?\n\}",
                  r"\1 }", src, flags=re.S)


def short_ring_patch():
    """DEPTH one deeper than the ring allows: the ring one row short."""
    return [("static constexpr int DEPTH = RING - (LAG * (KMAX - 1) + 4);",
             "static constexpr int DEPTH = RING - (LAG * (KMAX - 1) + 3);")]


def rows_patch(rows: int):
    """Strips of `rows` rows whatever the grid."""
    return [("  p.rows = strip_rows<T, NL>(p.n, WAVE_SMS * per_sm);",
             f"  p.rows = {rows};")]


def start(name: str, kernel="mg_sweep", patches=(), early=False, out=OUT,
          opt="-O1", reverse=False):
    """Start g++ on the translated csrc/<kernel>.cu with `patches`, into
    out/<name>.so (copies landing at their issue with early, a block's
    threads taking their turns last to first with reverse); returns
    (process, library path)."""
    out.mkdir(parents=True, exist_ok=True)
    src = (ROOT / "msom_tpu_torch" / "csrc" / f"{kernel}.cu").read_text()
    cpp = out / f"{name}.cpp"
    cpp.write_text(translate(src, list(LAUNCHES[kernel]) + list(patches)))
    target = out / f"{name}.so"
    # -fno-gnu-unique: the prelude's inline globals (blockIdx, gridDim,
    # emu_cur, ...) would otherwise be STB_GNU_UNIQUE symbols, which the
    # dynamic linker binds process-wide, across RTLD_LOCAL libraries: a
    # process that loaded tools/strip_emulation.py's library (its blockIdx
    # is thread_local) crashed loading this one
    cmd = ["g++", "-std=c++20", opt, "-w", "-ffp-contract=off",
           "-fno-gnu-unique", "-shared", "-fPIC", str(cpp), "-o",
           str(target)]
    if early:
        cmd.insert(1, "-DEMU_EARLY")
    if reverse:
        cmd.insert(1, "-DEMU_REVERSE")
    return subprocess.Popen(cmd), target


def finish(job) -> Path:
    proc, target = job
    if proc.wait(timeout=600) != 0:
        raise RuntimeError(f"k3_emulation: g++ failed for {target.name}")
    return target


def build(name: str, kernel="mg_sweep", patches=(), early=False, out=OUT,
          opt="-O1", reverse=False) -> Path:
    """`start` and wait: the library's path."""
    return finish(start(name, kernel, patches, early, out, opt, reverse))


def load(path: Path, kernel="mg_sweep"):
    lib = ctypes.CDLL(str(path))
    ptr, dbl, i32 = ctypes.c_void_p, ctypes.c_double, ctypes.c_int
    if kernel == "mg_sweep":
        for fn in (lib.mg_sweep_f32, lib.mg_sweep_f64):
            fn.argtypes = [ptr] * 6 + [i32, i32, dbl, dbl, dbl, i32, i32,
                                       ptr]
            fn.restype = i32
        lib.mg_sweep_per_launch.argtypes = [i32, i32, i32, i32]
        lib.mg_sweep_per_launch.restype = i32
    else:
        for fn in (lib.mg_residual_f32, lib.mg_residual_f64):
            fn.argtypes = [ptr] * 8 + [i32, i32, dbl, ctypes.POINTER(dbl),
                                       ctypes.POINTER(dbl), dbl, dbl, i32,
                                       ptr]
            fn.restype = i32
        lib.mg_residual_num_blocks.argtypes = [i32, i32, i32]
        lib.mg_residual_num_blocks.restype = i32
    return lib


def level(nl, n, dtype, modal, seed):
    """(level, idh0, idh1, da, res) on the CPU: random y-profile
    coefficients, layered or modal, as chip_smoke.py's `mg_level`."""
    rng = np.random.default_rng(seed)
    tdt = getattr(torch, dtype)
    s = lam = None
    idh0 = idh1 = np.zeros(nl)
    if modal:
        lam = torch.as_tensor(-rng.uniform(0.0, 5.0, (nl, n, 1)), dtype=tdt)
    elif nl > 1:
        s = torch.as_tensor(rng.uniform(0.5, 2.0, (nl - 1, n, 1)), dtype=tdt)
        idh0 = np.r_[0.0, rng.uniform(1, 3, nl - 1)]
        idh1 = np.r_[rng.uniform(1, 3, nl - 1), 0.0]
    lvl = mg._build_level(nl, n, 80.0 / n, s, lam, idh0, idh1, tdt,
                          torch.device("cpu"))
    da = torch.as_tensor(rng.standard_normal((nl, n, n)), dtype=tdt)
    res = torch.as_tensor(rng.standard_normal((nl, n, n)), dtype=tdt)
    return lvl, idh0, idh1, da, res


def emulated_relax(lib, da, res, prof, nsweep, d2, sign_x, sign_y,
                   periodic_x=False):
    """One emulated launch of nsweep sweeps; a new tensor (NaN where the
    kernel stored nothing)."""
    nl, n = da.shape[0], da.shape[-1]
    out = torch.full_like(da, float("nan"))
    fn = lib.mg_sweep_f64 if da.dtype == torch.float64 else lib.mg_sweep_f32
    rc = fn(da.data_ptr(), res.data_ptr(), prof.t0.data_ptr(),
            prof.cp.data_ptr(), prof.im.data_ptr(), out.data_ptr(), n, nl,
            d2, sign_x, sign_y, nsweep, int(periodic_x), None)
    if rc != 0:
        raise RuntimeError(f"k3_emulation: launch refused ({rc}) at n = {n}")
    return out


def sweep_mismatch(lib, n, nl, dtype, nsweep, modal=False,
                   signs=(-1.0, -1.0), periodic_x=False, seed=0):
    """Cells where one emulated launch of nsweep sweeps differs from
    nsweep plain sweeps (bitwise; NaN counts as a difference)."""
    lvl, _, _, da, res = level(nl, n, dtype, modal, seed + n + nl)
    kw = dict(d2=lvl.delta ** 2, sign_x=signs[0], sign_y=signs[1],
              periodic_x=periodic_x)
    got = emulated_relax(lib, da, res, lvl.sw, nsweep, **kw)
    want = fused_mg.relax_reference(da, res, lvl.sw, nrelax=nsweep, **kw)
    return int((got != want).sum())


def residual_error(lib, n, nl, dtype, modal=False, signs=(-1.0, -1.0),
                   periodic_x=False, nan_at=None, seed=0):
    """(largest error of res over max|res|, the maximum's error over it)
    of the emulated K4 against the plain version; with nan_at a cell of
    a made NaN, the maximum must be NaN (returns its error as 0 if so)."""
    lvl, idh0, idh1, a, b = level(nl, n, dtype, modal, seed + n + nl)
    if nan_at is not None:
        a[nan_at] = float("nan")
    kw = dict(delta=lvl.delta, idh0=idh0, idh1=idh1, sign_x=signs[0],
              sign_y=signs[1], periodic_x=periodic_x)
    r_p, m_p = fused_mg.residual_norm_reference(a, b, lvl.rp, **kw)
    res = torch.full_like(a, float("nan"))
    mx = torch.full((), float("nan"), dtype=a.dtype)
    nb = lib.mg_residual_num_blocks(n, nl, a.element_size())
    partial = torch.full((nb,), float("nan"), dtype=a.dtype)
    ticket = torch.zeros(1, dtype=torch.int32)
    fn = (lib.mg_residual_f64 if a.dtype == torch.float64
          else lib.mg_residual_f32)
    dbl = ctypes.c_double * nl
    prof = lvl.rp
    rc = fn(a.data_ptr(), b.data_ptr(),
            None if prof.s is None else prof.s.data_ptr(),
            None if prof.lam is None else prof.lam.data_ptr(),
            res.data_ptr(), partial.data_ptr(), ticket.data_ptr(),
            mx.data_ptr(), n, nl, lvl.delta, dbl(*idh0), dbl(*idh1),
            signs[0], signs[1], int(periodic_x), None)
    if rc != 0 or int(ticket) != 0:
        raise RuntimeError(f"k3_emulation: residual launch {rc}, ticket "
                           f"{int(ticket)} at n = {n}")
    if nan_at is not None:
        return 0.0 if bool(torch.isnan(mx)) else float("inf"), 0.0
    scale = float(r_p.abs().max())
    err = float((res - r_p).abs().max()) / scale
    return (err if np.isfinite(err) else float("inf"),
            abs(float(mx) - float(m_p)) / scale)


# (n, nl): partial strips in both directions (100, 130, 257: one column and
# one row past a strip), nl above and below the 128-column strip's reach
SWEEP_CASES = [(100, 3), (130, 4), (257, 1)]
# (n, nl) with strips that no wall is within reach of, at 64-row strips
INTERIOR = (264, 1)
RES_LIMIT = {"float64": 1e-12, "float32": 1e-5}
# faults the march must show: (name, patches, copies early)
MUTATIONS = [
    ("ring_short", short_ring_patch(), True),
    ("lag2", [("constexpr int LAG = 3;", "constexpr int LAG = 2;")], False),
    ("reach_short", [("const int rr = 2 * k - 2 * s - 1;",
                      "const int rr = 2 * k - 2 * s - 2;")], False),
    ("wait_short", [("    cp_async_wait<G::DEPTH - 1>();\n    __syncthreads();"
                     "\n  }", "    cp_async_wait<G::DEPTH>();\n"
                     "    __syncthreads();\n  }")], False),
    ("store_early", [("const int rs = g - LAG * (k - 1) - 1;",
                      "const int rs = g - LAG * (k - 1);")], False),
]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=OUT,
                    help="directory of the builds (default build/"
                         "k3_emulation)")
    out = ap.parse_args().out
    jobs = {"shipped": start("shipped", out=out),
            "reverse": start("reverse", out=out, reverse=True),
            "rows64": start("rows64", patches=rows_patch(64), out=out),
            "residual": start("residual", "mg_residual", out=out)}
    for name, patches, early in MUTATIONS:
        for rev in (False, True):
            jobs[name, rev] = start(f"{name}{'_reverse' * rev}",
                                    patches=patches, early=early, out=out,
                                    reverse=rev)
    libs = {name: finish(job) for name, job in jobs.items()}
    ok = True
    for dtype in ("float64", "float32"):
        lib = load(libs["shipped"])
        bad = sweep_mismatch(load(libs["reverse"]), 130, 4, dtype, KMAX)
        ok &= bad == 0
        print(f"K3 {dtype} n=130 nl=4 k={KMAX}, threads last to first: "
              f"{bad} cells differ", flush=True)
        bad = sweep_mismatch(load(libs["rows64"]), *INTERIOR, dtype, KMAX)
        ok &= bad == 0
        print(f"K3 {dtype} n={INTERIOR[0]} nl={INTERIOR[1]} k={KMAX}, "
              f"64-row strips (some with no wall within reach): {bad} cells "
              "differ", flush=True)
        for n, nl in SWEEP_CASES:
            for k in (1, 2, KMAX):
                bad = sweep_mismatch(lib, n, nl, dtype, k)
                ok &= bad == 0
                print(f"K3 {dtype} n={n} nl={nl} k={k}: {bad} cells differ "
                      f"from {k} plain sweeps", flush=True)
        for n, nl in ((64, 4), (32, 4), (16, 2)):
            if lib.mg_sweep_per_launch(n, nl, 8 if dtype == "float64" else 4,
                                       0) <= KMAX:
                continue          # not a whole level in this type
            bad = sweep_mismatch(lib, n, nl, dtype, 7, modal=True)
            ok &= bad == 0
            print(f"K3 {dtype} whole n={n} nl={nl} k=7: {bad} cells differ",
                  flush=True)
        bad = sweep_mismatch(lib, 64, 3, dtype, 1, periodic_x=True)
        ok &= bad == 0
        print(f"K3 {dtype} periodic_x n=64 nl=3: {bad} cells differ",
              flush=True)
    for name, _, early in MUTATIONS:
        bad = [sweep_mismatch(load(libs[name, rev]), 130, 2, "float64", KMAX)
               for rev in (False, True)]
        ok &= max(bad) > 0
        print(f"K3 mutation {name}{' (copies early)' if early else ''}: "
              f"{bad[0]} cells differ with the threads first to last, "
              f"{bad[1]} last to first "
              f"({'wrong, as it must be' if max(bad) else 'NOT SHOWN'})",
              flush=True)
    rlib = load(libs["residual"], "mg_residual")
    for dtype in ("float64", "float32"):
        for n, nl, px in ((100, 3, False), (130, 4, False), (257, 1, False),
                          (64, 3, True), (66, 2, True)):
            err, merr = residual_error(rlib, n, nl, dtype, periodic_x=px)
            good = err <= RES_LIMIT[dtype] and merr <= RES_LIMIT[dtype]
            ok &= good
            print(f"K4 {dtype} n={n} nl={nl} periodic_x={px}: res error "
                  f"{err:.3e}, max error {merr:.3e} "
                  f"{'ok' if good else 'WRONG'}", flush=True)
    nan, _ = residual_error(rlib, 100, 3, "float32", nan_at=(1, 50, 99))
    ok &= nan == 0.0
    print(f"K4 a NaN cell gives a NaN maximum: {nan == 0.0}")
    print("all right" if ok else "SOMETHING WRONG")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
