// Fused msqg tendency for Hopper (sm_90a): kernel K1 of the port.
//
// Replaces the Pallas TPU kernel `_rhs_kernel` (msom_tpu/models/pallas_rhs.py,
// entry `rhs_fused`): walls (free slip and partial slip) and the doubly
// periodic domain. From psi (nl, N, N) and the static coupling fields it
// computes, in one pass over device memory,
//
//   dq = -J(psi, zeta) + beta v                          (nl > 1 only)
//      - J(pp, zeta)                                      (with pp)
//      + strl(y) * idh1[l] * Jc_l  -  strl(y) * idh0[l] * Jc_l-1
//          Jc_l = -J(psi_l, psi_l+1) - J(pp_l, psi_l+1) - J(psi_l, pp_l+1)
//      - J(psi, zetap),  zetap = lap pp                   (_LS_RV)
//      + iRe  * (lap zeta + Gamma(zeta))                  (harmonic)
//      + iRe4 * (lap tmp + Gamma(tmp)),  tmp = lap zeta   (biharmonic)
//      - ek_top zeta_0 (layer 0), - ek_bot zeta_nl-1 (bottom layer)
//      - wind(y) (layer 0)
//      - J(psi_nl-1, topo) * iro(y) (bottom layer)        (with topo)
//      + qforc                                            (with qforc)
//
// with zeta = lap psi, -J the 12-point Arakawa bracket and Gamma the vertical
// stretching operator, plus the per-layer maximum |face velocity| of psi for
// the CFL controller, written per block to `umax_part` (nblocks, nl) and
// reduced by the caller (the JAX code also takes that max outside its
// kernel). With ENERGY_CONSERV advection (a `q` input) -J(psi, q) replaces
// -J(psi, zeta) and -J(psi_l, psi_l+1) leaves Jc. The stochastic variant
// (the STOCHASTIC flag, with q; msqg/qg_stochastic.h:17-111) keeps
// -J(psi, zeta) but in layer 0, drops -J(psi_l, psi_l+1) from Jc too, and
// adds -q / tr_stoch (pallas_rhs.py:526-564). An absent field is a null
// pointer, and its terms are skipped.
//
// The PERIODIC flag selects the doubly periodic kernel (a template case of
// its own, so the walled kernels are the code they were): psi, q, zeta and
// tmp have no wall and no ghost rule. Every input row is fetched modulo N,
// and the x-halo columns of the first and the last strip come from the
// other end of the row, so the halo cells of zeta and tmp are computed from
// the wrapped psi like any other. Beside them run two other laws: pp has
// the reference's custom non-wrap ghosts (msqg/qg.h:1105-1114), made at
// build; zetap wraps, but its ring is lap(pp_pad) wrapped, which is not
// lap(pp) at a wrapped position. So both are read padded, as the TPU
// kernel reads them (pallas_rhs.py:234-243), from `pp` and `zetap` in the
// layout of const.pp_t and const.zetap_t: (nl, N+2, N+8), pp_pad or
// zetap_pad with three zero columns on either side, so that column gx of
// the grid sits at gx + 4 of a row N + 8 long and the 16-byte chunks of
// the input rings stay aligned. Their rows -1 .. N go into input rings of
// their own, zetap's in place of the ring that the walled kernel computes.
// The topography keeps its Neumann ghosts (pallas_rhs.py:723), as with
// walls.
//
// Design: one block per column strip, marching down y (the TPU kernel's
// "full-width row slabs with a halo only at the ends", cut to a strip).
// A block of TX = 128 threads owns TX output columns and SY = 32 output rows
// for all nl layers; thread t is column x0 + t. It walks its rows in order
// and keeps ring buffers of whole rows (all layers of a row together) in
// shared memory: the inputs psi (and pp, q, topo) on a 4-column x-halo, RP =
// 9 rows; zeta = lap psi on a 2-column halo, RZ = 7 rows; tmp = lap zeta
// (and zetap = lap pp) on a 1-column halo, RM = 5 rows. Step s of the march
// computes zeta row s, tmp (and zetap) row s - 2 and the outputs of row
// s - 4: each stage reads only rows that an earlier step wrote, so a step
// has ONE barrier, at its end (two more start the block: after zeroing
// shared memory and after the first rows). The input rows arrive by
// cp.async (16-byte chunks where N and the pointers allow, else one element
// a copy), issued DEPTH = 2 steps before their first use, so the loads of
// row s + 3 overlap the arithmetic of step s. A strip runs SY + 6 steps and
// loads SY + 6 input rows: the y-halo is paid at the strip's two ends only
// ((SY + 6) / SY = 1.19), the x-halo is (TX + 6) / TX = 1.05 (TX + 8 = 1.06
// with the aligned chunks), and no cell is computed twice inside a strip.
// A stage's column is its thread's, with no division; the 2-4 halo columns
// of zeta and tmp go to one lane each of different warps (lap_row). At nl =
// 4 f32 uncoupled the rings take 46.8 KB and the kernel 128 registers: four
// blocks (16 warps) an SM, and 1024 strips at N = 2048 fill 132 SMs in
// 1.94 waves; pp and topo add 24.5 KB (3 blocks an SM, 168 registers).
// nl = 4, the configurations' depth, is a template case: its layer loops
// unroll and every ring offset is a constant; the loop over a run-time nl
// serves the other depths (tools/k1_variants.py times the two, and the
// other choices above, against each other). Layers: each thread
// walks the layers of its cell in order and carries the interface Jacobian
// Jc_l to layer l + 1 in a register. The CFL maxima: a running maximum per
// thread and layer (in registers with a compile-time nl, else in shared
// memory), reduced once at the block's end. The per-cell arithmetic (mjac,
// gamma_at, the Laplacians, the face speeds) does not depend on the march:
// the kernel and the plain version differ in the order of a few sums only.
// The scalars are rounded to T on the host.
//
// Rows mode (the TPU kernel's SMEM `row0`, pallas_rhs.py:462, :481): the
// block computes the output rows [row0, row0 + ny) of the N x N domain, a
// shard of a rows decomposition. The march runs in global row indices, so
// every wall rule keys on the global row; only the address of a row of psi
// and q changes (`in_row`): they come as one (nl, ny + 16, N) tensor, the
// shard with the 8-row halo slabs of its y-neighbours above and below
// (parallel/halo.ext_rows8), wrapped when periodic. pp, pp_t, zetap_t,
// topo, qforc and the y-profiles stay whole and are read at the global
// row; dq is (nl, ny, N). Rows mode is the compile-time constant EXT: this
// file builds the whole-domain kernels, and csrc/fused_rhs_rows.cu, which
// defines FUSED_RHS_ROWS and includes it, the rows kernels, a library of
// their own with the same C entries. As a run-time branch the rows
// addressing slowed the whole-domain kernels 2.5-6% on one H100 (PERF.md,
// PR 15); as a second translation unit it leaves their code as it was,
// and the two nvcc runs go side by side.
//
// Where it is likely to go wrong, and how the march meets it:
//  1. Wall ghosts of DERIVED fields: the ghost ring of zeta, tmp and zetap
//     is a rule applied to the field's own interior (pallas_rhs.py `_yfix`
//     of zeta, tmp and lap pp); it is never recomputed from psi's or pp's
//     ghosts. The thread that computes an interior cell next to a wall
//     writes that cell's ghosts (ghost row -1 or N, ghost column -1 or N,
//     the corner) in the same step, from the value it just computed; no
//     other thread writes a ghost, and no stage reads a row of the step
//     that writes it. Input ghosts are never fetched: after its own copy of
//     row 0, N - 1 or of column 0, N - 1 has landed (cp.async.wait_group
//     makes a thread's own copies visible to it), the thread that copied it
//     writes the ghost row or column by the Dirichlet rule (topo: Neumann).
//  2. Corner ghosts compose x after y, so a Dirichlet corner is +interior:
//     one sign per reflected axis (ops/bc.py `pad`). Topography is Neumann:
//     sign +1 on both axes.
//  3. Cells beyond the first ghost ring (shared memory is zeroed when the
//     block starts; stale ring rows past the bottom wall are never read)
//     never feed an interior output: each stage computes interior cells
//     only and reads at most one cell past them.
//  4. Wall faces enter umax through psi's ghost ring (corners included),
//     exactly as max_face_speed_layers evaluates them.
//  5. The biharmonic stacks two Laplacians on zeta (three on psi): at
//     N = 2048 each multiplies by ~8/delta^2, so f32 cancellation, not the
//     index logic, sets the f32 tolerance of the comparison.
//  6. Partial slip (cslip = sbc / ((0.5 sbc + 1) delta^2) > 0): the EDGE
//     ghosts of zeta and of tmp are cslip * (parent_interior - parent_ghost)
//     with parent psi for zeta and zeta (slip ghosts included) for tmp,
//     which is `_views_slip`'s 2c psi and `_lap_ghostvals`' c (zeta - 2c psi);
//     the CORNER ghosts keep the Dirichlet fill of the field's own interior
//     (ops/ghost.py `ghosted_slip`). The parent's ghost row is in its ring
//     one step before the child's first row is computed.
//  7. At nl == 1 the whole advection block is skipped, the pp terms with it,
//     but not the topography.
// All of the wall code runs in strips that touch a wall only (a test that
// is uniform over the block); interior strips run none of it.
// The periodic kernel's own hazards:
//  8. The wrapped halo of a strip that holds the whole width or height
//     (N < 128 or N <= 32) is the strip's own interior: it is fetched as an
//     input into slots of its own (rows are slotted by their unwrapped
//     index, -3 .. N + 2), never read from a ring slot that the march
//     overwrites. A 16-byte chunk at x0 - 4 or past N - 1 wraps whole when
//     N % V == 0 (else the copies are one element each). N >= 4: the halo
//     wraps once.
//  9. Three laws side by side: psi, q, zeta, tmp wrap; pp's and zetap's
//     ghosts are data, copied with their rows and never fixed; topo is
//     fixed by the Neumann rule as with walls.
// 10. The CFL maxima include the faces between column N - 1 and column 0
//     and between row N - 1 and row 0, through the wrapped neighbours.
// 11. Stochastic (either kernel): layer 0 loses its self-advection only;
//     beta and the pp terms stay, and -q / tr_stoch applies at nl > 1.
// 12. Rows mode: the slabs of a shard at a wall are never read (load skips
//     rows outside [0, N) unless periodic, and the wall rules fire at the
//     global rows 0 and N - 1); a shard reads at most 3 rows of a slab, so
//     any ny >= 1 works (the step keeps ny % 8 == 0, the JAX gate); a
//     partial last strip of ny % 32 rows ends the march as at N % 32.
//
// Bound. At 2048^2 x 4 in f32 the compulsory traffic of the uncoupled
// tendency is psi in and dq out, 2 * 4 * 2048^2 * 4 B = 134 MB, about 40 us
// at 3.35 TB/s; pp adds 4 planes and topo 1 (218 MB, about 65 us). The
// arithmetic is 130 to 240 FP32 operations per cell and layer
// (fused_rhs.bound_work counts them), 33 to 60 us at 67 TFLOP/s: the two
// bounds are of the same order. What this design spends beyond them is
// instruction issue: an output-layer takes about 100 FP32 instructions, 37
// loads from shared memory and the stages below it 12 more, with the
// address and loop work beside them, at 16 warps an SM. chip_smoke.py
// measures the distance from the bound.

#include <cuda_runtime.h>

#include <type_traits>

#ifndef FUSED_RHS_ROWS
#define FUSED_RHS_ROWS 0
#endif

namespace {

constexpr bool EXT = FUSED_RHS_ROWS;     // the rows mode (see above)

constexpr int TX = 128;                  // output columns of a strip
constexpr int NTH = TX;                  // threads: one a column
constexpr int SY = 32;                   // output rows of a strip
constexpr int MAXL = 16;                 // most layers the kernel takes
constexpr int DEPTH = 2;                 // steps an input row is issued early
// Input ring rows. At step s the stages read rows s - 5 .. s + 1, rows up
// to s + 1 + DEPTH are in flight, and the ghost row N is written with row
// N - 1 at the end of step N - 3: all of them need slots of their own.
constexpr int RP = DEPTH + 7 > 9 ? DEPTH + 7 : 9;
constexpr int RZ = 7;                    // zeta ring rows
constexpr int RM = 5;                    // tmp and zetap ring rows
constexpr int XH = 4;                    // input x-halo (3 used, 16-B chunks)
constexpr int PW = TX + 2 * XH;          // input ring row: col c = x0 - 4 + c
constexpr int ZW = TX + 4;               // zeta ring row:  col c = x0 - 2 + c
constexpr int MW = TX + 2;               // tmp ring row:   col c = x0 - 1 + c

// Order of the device pointers handed to the C entry points.
enum Ptr { PSI, STRL, WIND, DQ, UMAX, PP, Q, TOPO, IRO, QFORC, ZETAP, NPTRS };

// Bits of the launch's `flags`.
enum Flag { FLSRV = 1, PERIODIC = 2, STOCHASTIC = 4, ROWS = 8 };

// The scalars of a launch, rounded to T once on the host, and flags for
// the terms that are on.
template <typename T>
struct Params {
  int N, nl, flsrv, vec, has_re, has_re4, has_ekt, has_ekb;
  int row0, ny;        // rows mode: the output rows [row0, row0 + ny)
  T id2, i12d2, i2d, beta, iRe, iRe4, ek_top, ek_bot, cslip, itr_stoch;
  T idh0[MAXL], idh1[MAXL];
};

template <typename T>
struct Fields {
  const T *psi, *strl, *wind, *pp, *q, *topo, *iro, *qforc, *zetap;
  T *dq, *umax_part;
};

// Shared memory of one block, in elements: the input rings first (their
// rows are 16-byte aligned for cp.async; the periodic kernel's zetap is
// one), then the derived rings and the per-thread CFL maxima.
size_t smem_cells(int nl, int has_pg, int flsrv, int has_q, int has_topo,
                  int per) {
  const size_t in_planes =
      (size_t)nl * (1 + (has_pg ? 1 : 0) + (has_q ? 1 : 0)
                    + (flsrv && per ? 1 : 0)) + (has_topo ? 1 : 0);
  return in_planes * RP * PW + (size_t)nl * RZ * ZW
       + (size_t)nl * RM * MW * (flsrv && !per ? 2 : 1) + (size_t)nl * NTH;
}

__device__ __forceinline__ int slot(int r, int R) {
  return (r + 4 * R) % R;    // rows from -3 on
}

__device__ __forceinline__ bool interior(int g, int N) {
  return g >= 0 && g < N;
}

// Asynchronous copies into shared memory (cp.async, sm_80 and later).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(d), "l"(src), "n"(BYTES) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// Issue the copies of input row r (interior cells only) of a field of np
// planes into its ring: V elements a copy, V = 16 B / sizeof(T) where N and
// the pointers allow, else 1. A chunk lies wholly inside or outside the
// grid, since x0 - XH and N are multiples of V.
template <typename T, int V>
__device__ __forceinline__ void issue_row(T* ring, const T* __restrict__ src,
                                          int np, int r, int x0, int N,
                                          int tid) {
  constexpr int CW = PW / V;
  const size_t NN = (size_t)N * N;
  T* dst = ring + slot(r, RP) * np * PW;
  const T* s = src + (size_t)r * N;
  for (int k = tid; k < np * CW; k += NTH) {
    const int l = k / CW, j = k - l * CW, gx = x0 - XH + j * V;
    if (gx >= 0 && gx < N)
      cp_async<int(V * sizeof(T))>(dst + l * PW + j * V, s + l * NN + gx);
  }
}

// Periodic: the copies of input row r, taken modulo N, into its ring; the
// x-halo columns of the first and the last strip come from the other end of
// the row (hazard 8). Chunks start at multiples of V and N % V == 0, so a
// chunk wraps whole; columns past N + 3 are never read and not fetched.
template <typename T, int V>
__device__ __forceinline__ void issue_row_wrap(T* ring,
                                               const T* __restrict__ src,
                                               int np, int r, int x0, int N,
                                               int tid) {
  constexpr int CW = PW / V;
  const size_t NN = (size_t)N * N;
  T* dst = ring + slot(r, RP) * np * PW;
  const int rw = r < 0 ? r + N : (r >= N ? r - N : r);
  const T* s = src + (size_t)rw * N;
  for (int k = tid; k < np * CW; k += NTH) {
    const int l = k / CW, j = k - l * CW, gx = x0 - XH + j * V;
    if (gx >= N + XH) continue;
    const int gw = gx < 0 ? gx + N : (gx >= N ? gx - N : gx);
    cp_async<int(V * sizeof(T))>(dst + l * PW + j * V, s + l * NN + gw);
  }
}

// Rows mode (hazard 12): the copies of input row r of psi or q from `s`,
// its row in the slab tensor's first plane, the planes `plane` apart; with
// XWRAP (periodic) the x-halo chunks of the first and the last strip from
// the other end of the row, as issue_row_wrap takes them.
template <typename T, int V, bool XWRAP>
__device__ __forceinline__ void issue_slab_row(T* ring,
                                               const T* __restrict__ s,
                                               size_t plane, int np, int r,
                                               int x0, int N, int tid) {
  constexpr int CW = PW / V;
  T* dst = ring + slot(r, RP) * np * PW;
  for (int k = tid; k < np * CW; k += NTH) {
    const int l = k / CW, j = k - l * CW;
    int gx = x0 - XH + j * V;
    if constexpr (XWRAP) {
      if (gx >= N + XH) continue;
      gx = gx < 0 ? gx + N : (gx >= N ? gx - N : gx);
    } else if (gx < 0 || gx >= N) {
      continue;
    }
    cp_async<int(V * sizeof(T))>(dst + l * PW + j * V, s + l * plane + gx);
  }
}

// Periodic pp and zetap: row r (-1 .. N) of a padded field in the layout
// (np, N + 2, N + 8), grid column gx at gx + 4 (hazard 9). A chunk starts
// at a multiple of V in a row whose length is one, so it stays aligned;
// columns past N + 3 lie past the row and are never read.
template <typename T, int V>
__device__ __forceinline__ void issue_row_pad(T* ring,
                                              const T* __restrict__ src,
                                              int np, int r, int x0, int N,
                                              int tid) {
  constexpr int CW = PW / V;
  const size_t P = (size_t)N + 2 * XH;
  T* dst = ring + slot(r, RP) * np * PW;
  const T* s = src + (size_t)(r + 1) * P + XH;
  for (int k = tid; k < np * CW; k += NTH) {
    const int l = k / CW, j = k - l * CW, gx = x0 - XH + j * V;
    if (gx < N + XH)
      cp_async<int(V * sizeof(T))>(dst + l * PW + j * V,
                                   s + l * (N + 2) * P + gx);
  }
}

// The ghosts that this thread's own copies of input row r feed (hazards 1,
// 2): ghost row -1 from row 0, ghost row N from row N - 1, ghost columns
// -1 and N, and the corners; `sign` -1 (Dirichlet) or +1 (Neumann). Runs
// after the thread's wait on row r, before the barrier that publishes it.
template <typename T, int V>
__device__ __forceinline__ void fix_row(T* ring, int np, int r, int x0,
                                        int N, int tid, T sign) {
  constexpr int CW = PW / V;
  const bool top = r == 0, bot = r == N - 1;
  T* row = ring + slot(r, RP) * np * PW;
  T* up = ring + slot(r - 1, RP) * np * PW;
  T* dn = ring + slot(r + 1, RP) * np * PW;
  for (int k = tid; k < np * CW; k += NTH) {
    const int l = k / CW, j = k - l * CW, gx0 = x0 - XH + j * V;
    if (gx0 < 0 || gx0 >= N) continue;
    if (!top && !bot && gx0 > 0 && gx0 + V < N) continue;   // no wall cell
    for (int e = 0; e < V; ++e) {
      const int c = l * PW + j * V + e, gx = gx0 + e;
      const T v = row[c];
      if (top) up[c] = sign * v;
      if (bot) dn[c] = sign * v;
      if (gx == 0 && j * V + e > 0) {
        row[c - 1] = sign * v;
        if (top) up[c - 1] = v;
        if (bot) dn[c - 1] = v;
      }
      if (gx == N - 1 && j * V + e + 1 < PW) {
        row[c + 1] = sign * v;
        if (top) up[c + 1] = v;
        if (bot) dn[c + 1] = v;
      }
    }
  }
}

// The eight neighbours of a cell.
template <typename T>
struct Nb {
  T e, w, n, s, ne, nw, se, sw;
};

// Neighbours of the cell c points at; m and p point at the same column of
// the rows below (y - 1) and above (y + 1).
template <typename T>
__device__ __forceinline__ Nb<T> nb3(const T* m, const T* c, const T* p) {
  return {c[1], c[-1], p[0], m[0], p[1], p[-1], m[1], m[-1]};
}

// -J(p, q), the 12-point Arakawa bracket (ops/ghost.arakawa_mjac_g).
template <typename T>
__device__ __forceinline__ T mjac(const Nb<T>& p, const Nb<T>& q, T i12d2) {
  const T j = (q.e - q.w) * (p.n - p.s) + (q.s - q.n) * (p.e - p.w)
            + q.e * (p.ne - p.se) - q.w * (p.nw - p.sw)
            - q.n * (p.ne - p.nw) + q.s * (p.se - p.sw)
            + p.n * (q.ne - q.nw) - p.s * (q.se - q.sw)
            - p.e * (q.ne - q.se) + p.w * (q.nw - q.sw);
  return j * i12d2;
}

// The 5-point Laplacian of the cell c points at, rows m below and p above.
template <typename T>
__device__ __forceinline__ T lap3(const T* m, const T* c, const T* p, T id2) {
  return (c[1] + c[-1] + p[0] + m[0] - T(4) * c[0]) * id2;
}

// Gamma(a)[l] at one cell; a points at layer l's cell, layers `plane` apart;
// s0 and s1 the stretching profiles of the interfaces above and below.
template <typename T>
__device__ __forceinline__ T gamma_at(const T* a, int plane, int l, int nl,
                                      T s0, T s1, const Params<T>& p) {
  T g = T(0);
  if (l > 0) g += p.idh0[l] * (s0 * (a[-plane] - a[0]));
  if (l < nl - 1) g += p.idh1[l] * (s1 * (a[plane] - a[0]));
  return g;
}

// One cell (gy, column c of f's ring row) of f = lap(parent), all nl
// layers, if it is interior. f's ring rows are W wide with column c at
// x0 - h + c; the parent's rows (ring R_PAR, width PWP) hold column c of f
// at c + (hp - h), hp being the parent's halo. In a wall strip (`edge`) the
// thread of a cell next to a wall also writes that cell's ghosts: the
// Dirichlet rule on f's own value (hazard 1), corners +value (hazard 2),
// with cslip != 0 the edge ghosts cslip * (parent interior - parent ghost)
// instead (hazard 6). With nl a compile-time NL every layer's loads come
// before the first store, which a store through a generic pointer would
// otherwise hold back. PER: the periodic kernel, where every cell of the
// ring row is computed from the wrapped parent and no ghost is written.
template <typename T, int NL, int W, int R, int h, int PWP, int R_PAR, int hp,
          bool PER>
__device__ __forceinline__ void lap_cell(T* f, const T* par, int gy, int c,
                                         int x0, int nl, int N, bool edge,
                                         T id2, T cslip) {
  constexpr int off = hp - h;
  const int gx = x0 - h + c;
  if (!PER && !interior(gx, N)) return;
  const T* pm = par + slot(gy - 1, R_PAR) * nl * PWP;
  const T* p0 = par + slot(gy, R_PAR) * nl * PWP;
  const T* pp = par + slot(gy + 1, R_PAR) * nl * PWP;
  T* f0 = f + slot(gy, R) * nl * W;
  if constexpr (NL > 0) {
    T v[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const int a = l * PWP + c + off;
      v[l] = lap3(pm + a, p0 + a, pp + a, id2);
    }
#pragma unroll
    for (int l = 0; l < NL; ++l) f0[l * W + c] = v[l];
  } else {
    for (int l = 0; l < nl; ++l) {
      const int a = l * PWP + c + off;
      f0[l * W + c] = lap3(pm + a, p0 + a, pp + a, id2);
    }
  }
  const bool top = gy == 0, bot = gy == N - 1;
  if (PER || !(edge && (top || bot || gx == 0 || gx == N - 1))) return;
  // the ghosts of a cell next to a wall, from the values just written
  T* fu = f + slot(gy - 1, R) * nl * W;
  T* fd = f + slot(gy + 1, R) * nl * W;
  const bool lft = gx == 0, rgt = gx == N - 1 && c + 1 < W;
  for (int l = 0; l < nl; ++l) {
    const int a = l * PWP + c + off, b = l * W + c;
    const T v = f0[b];
    if (top) fu[b] = cslip != T(0) ? cslip * (p0[a] - pm[a]) : -v;
    if (bot) fd[b] = cslip != T(0) ? cslip * (p0[a] - pp[a]) : -v;
    if (lft) {
      f0[b - 1] = cslip != T(0) ? cslip * (p0[a] - p0[a - 1]) : -v;
      if (top) fu[b - 1] = v;
      if (bot) fd[b - 1] = v;
    }
    if (rgt) {
      f0[b + 1] = cslip != T(0) ? cslip * (p0[a] - p0[a + 1]) : -v;
      if (top) fu[b + 1] = v;
      if (bot) fd[b + 1] = v;
    }
  }
}

// Row gy of f = lap(parent) (see lap_cell). Thread t takes column x0 + t,
// the one of its output; the 2h halo columns go to the last lane of warps
// 0 .. 2h - 1, so that no warp takes two of them, and in a strip at an
// x-wall the wall cell's ghosts fall to the first or the last warp alone.
template <typename T, int NL, int W, int R, int h, int PWP, int R_PAR, int hp,
          bool PER>
__device__ __forceinline__ void lap_row(T* f, const T* par, int gy, int x0,
                                        int nl, int N, bool edge, T id2,
                                        T cslip, int tid) {
  static_assert(W == NTH + 2 * h && 2 * h <= NTH / 32, "halo lanes");
  lap_cell<T, NL, W, R, h, PWP, R_PAR, hp, PER>(f, par, gy, tid + h, x0, nl,
                                                N, edge, id2, cslip);
  const int e = tid >> 5;
  if ((tid & 31) == 31 && e < 2 * h)
    lap_cell<T, NL, W, R, h, PWP, R_PAR, hp, PER>(
        f, par, gy, e < h ? e : NTH + e, x0, nl, N, edge, id2, cslip);
}

// COUPLED = false is the uncoupled free-slip (or periodic) tendency: every
// coupling term below is compiled out, which keeps that launch at its
// registers and its speed. COUPLED = true takes the options at run time
// from the null pointers of F and from p.cslip and p.flsrv. PER = true is
// the periodic kernel (hazards 8-10), STOCH = true (with COUPLED, q given)
// the stochastic variant (hazard 11): template cases of their own, so the
// walled kernels are the code they were.
template <typename T, bool COUPLED, int NL, bool PER, bool STOCH>
__global__ void __launch_bounds__(NTH, COUPLED ? 3 : 4)
rhs_kernel(const Fields<T> F, const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = p.N, nl = NL > 0 ? NL : p.nl;
  const bool has_pg = COUPLED && F.pp != nullptr;
  const bool flsrv = COUPLED && p.flsrv != 0;
  constexpr bool stoch = COUPLED && STOCH;
  const bool has_q = COUPLED && F.q != nullptr;
  const bool has_topo = COUPLED && F.topo != nullptr;
  T* sp = reinterpret_cast<T*>(smem_raw);          // psi   (RP, nl, PW)
  T* spp = sp + RP * nl * PW;                       // pp    (RP, nl, PW)
  T* sq = spp + (has_pg ? RP * nl * PW : 0);        // q     (RP, nl, PW)
  T* st = sq + (has_q ? RP * nl * PW : 0);          // topo  (RP, 1, PW)
  T* szi = st + (has_topo ? RP * PW : 0);           // periodic zetap
  //                                                   (RP, nl, PW)
  T* sz = szi + (PER && flsrv ? RP * nl * PW : 0);  // zeta  (RZ, nl, ZW)
  T* sm = sz + RZ * nl * ZW;                        // tmp   (RM, nl, MW)
  T* szp = PER ? szi : sm + RM * nl * MW;           // zetap (RM, nl, MW)
  T* smax = sm + RM * nl * MW
          + (flsrv && !PER ? RM * nl * MW : 0);     // CFL   (nl, NTH)
  const int ncells = static_cast<int>(smax - sp) + nl * NTH;

  const int tid = threadIdx.x;
  const int row0 = EXT ? p.row0 : 0, ny = EXT ? p.ny : N;
  const int x0 = blockIdx.x * TX, y0 = row0 + blockIdx.y * SY;
  const int y1 = min(y0 + SY, row0 + ny);           // output rows [y0, y1)
  const size_t NN = (size_t)N * N;
  // psi and q: whole planes, or in rows mode (hazard 12) the shard's
  // ny + 16 rows, global row r at row r - row0 + 8; dq: the ny rows
  const size_t IN = EXT ? (size_t)(ny + 16) * N : NN;
  const size_t ON = EXT ? (size_t)ny * N : NN;
  const T id2 = p.id2, i12d2 = p.i12d2, i2d = p.i2d;
  const T cslip = COUPLED ? p.cslip : T(0);
  // a strip whose rings reach a wall's first ghost cell; xwall: an x-wall,
  // whose ghost columns every input row feeds
  const bool xwall = x0 <= XH || x0 + TX + XH >= N;
  const bool edge = xwall || y0 <= 3 || y1 + 3 >= N;

  for (int k = tid; k < ncells; k += NTH) sp[k] = T(0);   // hazard 3
  __syncthreads();

  // f(std::integral_constant<int, V>) with this launch's copy width V
  auto with_v = [&](auto f) {
    if (p.vec)
      f(std::integral_constant<int, 16 / sizeof(T)>());
    else
      f(std::integral_constant<int, 1>());
  };
  // the copies of input row r (the rows [y0 - 3, y1 + 2] that lie in the
  // grid; periodic: all of them, wrapped, pp's and zetap's rows -1 .. N
  // and topo's that lie in the grid) and, once they have landed, the
  // ghosts they feed (periodic: topo's only)
  auto load = [&](int r) {
    if (r > y1 + 2 || (!PER && (r < 0 || r >= N))) return;
    with_v([&](auto v) {
      constexpr int V = decltype(v)::value;
      if constexpr (EXT) {   // psi and q from the slabs (hazard 12)
        const size_t ro = (size_t)(r - row0 + 8) * N;
        issue_slab_row<T, V, PER>(sp, F.psi + ro, IN, nl, r, x0, N, tid);
        if (has_q)
          issue_slab_row<T, V, PER>(sq, F.q + ro, IN, nl, r, x0, N, tid);
      }
      if constexpr (PER) {
        if constexpr (!EXT) issue_row_wrap<T, V>(sp, F.psi, nl, r, x0, N, tid);
        if (has_pg && r >= -1 && r <= N) {
          issue_row_pad<T, V>(spp, F.pp, nl, r, x0, N, tid);
          if (flsrv) issue_row_pad<T, V>(szp, F.zetap, nl, r, x0, N, tid);
        }
        if (!EXT && has_q) issue_row_wrap<T, V>(sq, F.q, nl, r, x0, N, tid);
        if (has_topo && interior(r, N))
          issue_row<T, V>(st, F.topo, 1, r, x0, N, tid);
      } else {
        if constexpr (!EXT) issue_row<T, V>(sp, F.psi, nl, r, x0, N, tid);
        if (has_pg) issue_row<T, V>(spp, F.pp, nl, r, x0, N, tid);
        if (!EXT && has_q) issue_row<T, V>(sq, F.q, nl, r, x0, N, tid);
        if (has_topo) issue_row<T, V>(st, F.topo, 1, r, x0, N, tid);
      }
    });
  };
  auto fix = [&](int r) {
    if (!(xwall || r == 0 || r == N - 1) || r < 0 || r >= N || r > y1 + 2)
      return;
    if (PER && !has_topo) return;
    with_v([&](auto v) {
      constexpr int V = decltype(v)::value;
      if constexpr (!PER) {
        fix_row<T, V>(sp, nl, r, x0, N, tid, T(-1));
        if (has_pg) fix_row<T, V>(spp, nl, r, x0, N, tid, T(-1));
        if (has_q) fix_row<T, V>(sq, nl, r, x0, N, tid, T(-1));
      }
      if (has_topo) fix_row<T, V>(st, 1, r, x0, N, tid, T(1));
    });
  };

  // prologue: rows y0 - 3 .. y0 - 1 (read by the first step) in one group,
  // then rows y0 .. y0 + DEPTH - 2 a group each; step s then issues row
  // s + 1 + DEPTH and waits for row s + 2
  const int s0 = y0 - 2;
  for (int r = s0 - 1; r <= s0 + 1; ++r) load(r);
  cp_async_commit();
  for (int r = s0 + 2; r <= s0 + DEPTH; ++r) {
    load(r);
    cp_async_commit();
  }
  cp_async_wait<DEPTH - 1>();
  for (int r = s0 - 1; r <= s0 + 1; ++r) fix(r);
  __syncthreads();

  const int gx = x0 + tid;
  // with a compile-time NL the CFL maxima stay in registers, and a cell's
  // outputs are stored after all of its loads (see lap_cell)
  T umx[NL > 0 ? NL : 1];
  for (int l = 0; l < (NL > 0 ? NL : 1); ++l) umx[l] = T(0);
  for (int s = s0; s <= y1 + 3; ++s) {
    load(s + 1 + DEPTH);
    cp_async_commit();

    // zeta row s
    if (s <= y1 + 1 && (PER || interior(s, N)))
      lap_row<T, NL, ZW, RZ, 2, PW, RP, XH, PER>(sz, sp, s, x0, nl, N, edge,
                                                 id2, cslip, tid);
    // tmp (and zetap) row s - 2
    const int t = s - 2;
    if (t >= y0 - 1 && t <= y1 && (PER || interior(t, N))) {
      lap_row<T, NL, MW, RM, 1, ZW, RZ, 2, PER>(sm, sz, t, x0, nl, N, edge,
                                                id2, cslip, tid);
      if (flsrv && !PER)
        lap_row<T, NL, MW, RM, 1, PW, RP, XH, PER>(szp, spp, t, x0, nl, N,
                                                   edge, id2, T(0), tid);
    }

    // the outputs of row s - 4, layer by layer
    const int gy = s - 4;
    if (gy >= y0 && gy < y1 && gx < N) {
      const int ip = tid + XH, iz = tid + 2, im = tid + 1;
      const int kpm = slot(gy - 1, RP) * nl * PW + ip;
      const int kp0 = slot(gy, RP) * nl * PW + ip;
      const int kpp = slot(gy + 1, RP) * nl * PW + ip;
      const T* Zm = sz + slot(gy - 1, RZ) * nl * ZW + iz;
      const T* Z0 = sz + slot(gy, RZ) * nl * ZW + iz;
      const T* Zp = sz + slot(gy + 1, RZ) * nl * ZW + iz;
      const int kmm = slot(gy - 1, RM) * nl * MW + im;
      const int km0 = slot(gy, RM) * nl * MW + im;
      const int kmp = slot(gy + 1, RM) * nl * MW + im;
      const int ktm = slot(gy - 1, RP) * PW + ip;     // topo: one plane
      const int kt0 = slot(gy, RP) * PW + ip;
      const int ktp = slot(gy + 1, RP) * PW + ip;
      T jprev = T(0);   // the interface Jacobian Jc_l-1 at this cell
      T sprev = T(0);   // the stretching profile of that interface
      T res[NL > 0 ? NL : 1], spd[NL > 0 ? NL : 1];
#pragma unroll
      for (int l = 0; l < nl; ++l) {
        const T scur = l < nl - 1 ? F.strl[l * N + gy] : T(0);
        const int lp = l * PW, lz = l * ZW, lm = l * MW;
        const Nb<T> pn = nb3(sp + kpm + lp, sp + kp0 + lp, sp + kpp + lp);
        const T* Z = Z0 + lz;
        const T* M = sm + km0 + lm;
        T acc = T(0);
        if (nl > 1) {   // hazard 7
          const Nb<T> zn = nb3(Zm + lz, Z, Zp + lz);
          if (has_q && !stoch)
            acc = mjac(pn, nb3(sq + kpm + lp, sq + kp0 + lp, sq + kpp + lp),
                       i12d2);
          else if (!(stoch && l == 0))   // hazard 11
            acc = mjac(pn, zn, i12d2);
          acc += p.beta * (pn.w - pn.e) * i2d;
          Nb<T> qn;
          if (has_pg) {
            qn = nb3(spp + kpm + lp, spp + kp0 + lp, spp + kpp + lp);
            acc += mjac(qn, zn, i12d2);
          }
          T jnext = T(0);
          if (l < nl - 1) {
            const Nb<T> pup = nb3(sp + kpm + lp + PW, sp + kp0 + lp + PW,
                                  sp + kpp + lp + PW);
            if (has_pg)
              jnext = mjac(qn, pup, i12d2)
                    + mjac(pn, nb3(spp + kpm + lp + PW, spp + kp0 + lp + PW,
                                   spp + kpp + lp + PW), i12d2);
            if (!has_q) jnext += mjac(pn, pup, i12d2);
            acc += scur * jnext * p.idh1[l];
          }
          if (l > 0) acc -= sprev * jprev * p.idh0[l];
          jprev = jnext;
          if (flsrv && PER)
            acc += mjac(pn, nb3(szp + kpm + lp, szp + kp0 + lp,
                                szp + kpp + lp), i12d2);
          else if (flsrv)
            acc += mjac(pn, nb3(szp + kmm + lm, szp + km0 + lm,
                                szp + kmp + lm), i12d2);
          if (stoch) acc -= sq[kp0 + lp] * p.itr_stoch;
        }
        if (p.has_re) {
          acc += p.iRe * M[0];
          if (nl > 1) acc += p.iRe * gamma_at(Z, ZW, l, nl, sprev, scur, p);
        }
        if (p.has_re4) {
          T bih = lap3(sm + kmm + lm, M, sm + kmp + lm, id2);
          if (nl > 1) bih += gamma_at(M, MW, l, nl, sprev, scur, p);
          acc += p.iRe4 * bih;
        }
        if (l == 0 && p.has_ekt) acc -= p.ek_top * Z[0];
        if (l == nl - 1 && p.has_ekb) acc -= p.ek_bot * Z[0];
        if (l == 0) acc -= F.wind[gy];
        if (has_topo && l == nl - 1)
          acc += mjac(pn, nb3(st + ktm, st + kt0, st + ktp), i12d2)
                 * F.iro[gy];

        // the four faces of this cell (hazard 4: wall faces via the ghosts)
        const T uc = -(pn.n - pn.s) * i2d;
        const T ucW = -(pn.nw - pn.sw) * i2d;
        const T ucE = -(pn.ne - pn.se) * i2d;
        const T vc = (pn.e - pn.w) * i2d;
        const T vcS = (pn.se - pn.sw) * i2d;
        const T vcN = (pn.ne - pn.nw) * i2d;
        const T speed = fmax(fmax(fabs(T(0.5) * (uc + ucW)),
                                  fabs(T(0.5) * (uc + ucE))),
                             fmax(fabs(T(0.5) * (vc + vcS)),
                                  fabs(T(0.5) * (vc + vcN))));
        const size_t o = l * NN + (size_t)gy * N + gx;
        if (COUPLED && F.qforc != nullptr) acc += F.qforc[o];
        if constexpr (NL > 0) {
          res[l] = acc;
          spd[l] = speed;
        } else {
          F.dq[EXT ? l * ON + (size_t)(gy - row0) * N + gx : o] = acc;
          smax[l * NTH + tid] = fmax(smax[l * NTH + tid], speed);
        }
        sprev = scur;
      }
      if constexpr (NL > 0) {
#pragma unroll
        for (int l = 0; l < NL; ++l) {
          F.dq[EXT ? l * ON + (size_t)(gy - row0) * N + gx
                   : l * NN + (size_t)gy * N + gx] = res[l];
          umx[l] = fmax(umx[l], spd[l]);
        }
      }
    }

    // row s + 2, read from the next step on, has landed: its ghosts, then
    // the step's one barrier
    cp_async_wait<DEPTH - 1>();
    fix(s + 2);
    __syncthreads();
  }
  cp_async_wait<0>();
  if constexpr (NL > 0) {
#pragma unroll
    for (int l = 0; l < NL; ++l) smax[l * NTH + tid] = umx[l];
    __syncthreads();
  }

  if (tid < nl) {
    T m = smax[tid * NTH];
    for (int i = 1; i < NTH; ++i) m = fmax(m, smax[tid * NTH + i]);
    F.umax_part[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * nl + tid] = m;
  }
}

template <typename T>
int run(void (*kernel)(const Fields<T>, const Params<T>),
        const Fields<T>& F, const Params<T>& p, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.N + TX - 1) / TX, (p.ny + SY - 1) / SY), block(NTH);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(F, p);
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<size_t>(ptr) & 15) == 0;
}

template <typename T>
int launch(const void* const* ptrs, int N, int nl, int flags,
           const double* scal, const double* idh0, const double* idh1,
           int row0, int ny, void* stream) {
  const bool flsrv = flags & FLSRV, per = flags & PERIODIC,
             stoch = flags & STOCHASTIC, rows = flags & ROWS;
  if (nl < 1 || nl > MAXL || N < 1 || (per && N < 4) || ny < 1 || row0 < 0
      || row0 + ny > N || rows != EXT || (!rows && (row0 != 0 || ny != N)))
    return (int)cudaErrorInvalidValue;
  if (!ptrs[PSI] || !ptrs[WIND] || !ptrs[DQ] || !ptrs[UMAX]
      || (nl > 1 && !ptrs[STRL]) || (flsrv && !ptrs[PP])
      || (flsrv && per && !ptrs[ZETAP]) || (ptrs[TOPO] && !ptrs[IRO])
      || (stoch && !ptrs[Q]) || (per && scal[6] != 0.0))
    return (int)cudaErrorInvalidValue;
  Fields<T> F;
  F.psi = static_cast<const T*>(ptrs[PSI]);
  F.strl = static_cast<const T*>(ptrs[STRL]);
  F.wind = static_cast<const T*>(ptrs[WIND]);
  F.pp = static_cast<const T*>(ptrs[PP]);
  F.q = static_cast<const T*>(ptrs[Q]);
  F.topo = static_cast<const T*>(ptrs[TOPO]);
  F.iro = static_cast<const T*>(ptrs[IRO]);
  F.qforc = static_cast<const T*>(ptrs[QFORC]);
  F.zetap = static_cast<const T*>(ptrs[ZETAP]);
  F.dq = static_cast<T*>(const_cast<void*>(ptrs[DQ]));
  F.umax_part = static_cast<T*>(const_cast<void*>(ptrs[UMAX]));
  Params<T> p;
  p.N = N;
  p.nl = nl;
  p.flsrv = flsrv;
  p.row0 = row0;
  p.ny = ny;
  // 16-byte copies need every input row to start on 16 bytes
  p.vec = N % (16 / (int)sizeof(T)) == 0 && aligned16(F.psi)
       && (!F.pp || aligned16(F.pp)) && (!F.q || aligned16(F.q))
       && (!F.topo || aligned16(F.topo))
       && (!F.zetap || aligned16(F.zetap));
  const double delta = scal[0];
  p.id2 = T(1.0 / (delta * delta));
  p.i12d2 = T(1.0 / (12.0 * delta * delta));
  p.i2d = T(1.0 / (2.0 * delta));
  p.beta = T(scal[1]);
  p.iRe = T(scal[2]);
  p.iRe4 = T(scal[3]);
  p.ek_top = T(scal[4]);
  p.ek_bot = T(scal[5]);
  p.cslip = T(scal[6]);
  p.itr_stoch = T(scal[7]);
  p.has_re = scal[2] != 0.0;
  p.has_re4 = scal[3] != 0.0;
  p.has_ekt = scal[4] != 0.0;
  p.has_ekb = scal[5] != 0.0;
  for (int l = 0; l < MAXL; ++l) {
    p.idh0[l] = T(l < nl ? idh0[l] : 0.0);
    p.idh1[l] = T(l < nl ? idh1[l] : 0.0);
  }
  const bool coupled = F.pp || F.q || F.topo || F.qforc || scal[6] != 0.0;
  const size_t smem = sizeof(T) * smem_cells(nl, F.pp != nullptr, p.flsrv,
                                             F.q != nullptr,
                                             F.topo != nullptr, per);
  // the kernel of this option set: walled or periodic, stochastic or not,
  // coupled or not, nl = 4 or a run-time nl
  auto pick = [&](auto per_c, auto stoch_c) {
    constexpr bool P = decltype(per_c)::value, S = decltype(stoch_c)::value;
    if (nl == 4)
      return coupled ? run(rhs_kernel<T, true, 4, P, S>, F, p, smem, stream)
                     : run(rhs_kernel<T, false, 4, P, false>, F, p, smem,
                           stream);
    return coupled ? run(rhs_kernel<T, true, 0, P, S>, F, p, smem, stream)
                   : run(rhs_kernel<T, false, 0, P, false>, F, p, smem,
                         stream);
  };
  using yes = std::true_type;
  using no = std::false_type;
  if (per) return stoch ? pick(yes(), yes()) : pick(yes(), no());
  return stoch ? pick(no(), yes()) : pick(no(), no());
}

}  // namespace

extern "C" {

// Number of strips (TX columns by SY rows) of ny output rows of width N,
// the rows of `umax_part`.
int fused_rhs_num_blocks(int N, int ny) {
  return ((N + TX - 1) / TX) * ((ny + SY - 1) / SY);
}

// Dynamic shared memory of one block, in bytes, for an option set (periodic
// != 0: the periodic kernel).
long long fused_rhs_smem_bytes(int nl, int itemsize, int has_pg, int flsrv,
                               int has_q, int has_topo, int periodic) {
  return (long long)itemsize
       * (long long)smem_cells(nl, has_pg, flsrv, has_q, has_topo, periodic);
}

// ptrs = device pointers in the order of `Ptr` (psi, strl, wind, dq,
// umax_part, pp, q, topo, iro, qforc, zetap), null where a field is absent:
// pp switches the large-scale coupling on (in the periodic kernel pp_t,
// (nl, N+2, N+8)), q ENERGY_CONSERV advection or with STOCHASTIC the
// stochastic variant, topo (with iro) the topography, qforc the forcing,
// zetap (periodic with FLSRV only) zetap_t. flags: FLSRV adds _LS_RV
// (needs pp), PERIODIC the doubly periodic kernel (N >= 4, no slip),
// STOCHASTIC the stochastic variant (needs q), ROWS the rows mode (the
// library of fused_rhs_rows.cu takes it, this one refuses it): the
// output rows [row0, row0 + ny) of the N x N domain, psi and q the
// shard's (nl, ny + 16, N) halo-extended slabs, dq (nl, ny, N), the other
// fields whole (without ROWS, row0 = 0 and ny = N). scal = {delta, beta,
// iRe, iRe4, ek_top, ek_bot, cslip, itr_stoch}; idh0/idh1 host arrays of
// nl doubles. Launches on `stream` and returns the CUDA error code of the
// launch (0 on success).
int fused_rhs_f32(const void* const* ptrs, int N, int nl, int flags,
                  const double* scal, const double* idh0, const double* idh1,
                  int row0, int ny, void* stream) {
  return launch<float>(ptrs, N, nl, flags, scal, idh0, idh1, row0, ny,
                       stream);
}

int fused_rhs_f64(const void* const* ptrs, int N, int nl, int flags,
                  const double* scal, const double* idh0, const double* idh1,
                  int row0, int ny, void* stream) {
  return launch<double>(ptrs, N, nl, flags, scal, idh0, idh1, row0, ny,
                        stream);
}

const char* fused_rhs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
