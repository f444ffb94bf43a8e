// Fused qg-node tendency on the vertex grid for Hopper (sm_90a): kernel K5 of
// the port.
//
// Replaces the Pallas TPU kernel `_node_kernel`
// (msom_tpu/models/pallas_node_rhs.py, entry `rhs_fused_node`). From psi
// (nl, M, M) on the M = N+1 vertices, the interior mask (M, M) and the static
// fields it computes, in one pass over device memory, the walled rhs_pv
// (qg_baroclinic_ms.h:103-196; models/qg_node.py):
//
//   p      = psi * mask
//   zeta   = lap p on the interior nodes; on the ring the partial-slip rule
//            c2 * p(first interior node), corners 0            (bc_deriv)
//   dq     = -J(p, zeta) - beta (pE - pW) / (2 delta)
//            - J(pp, zeta)                                      (with pp)
//            - s_l(y) idh1[l] Jd_l + s_l-1(y) idh0[l] Jd_l-1
//               Jd_l = J(p_l, p_l+1) + J(pp_l, p_l+1) + J(p_l, pp_l+1)
//            - fric zeta - J(p, topo) topo_fac    (bottom layer; topo opt.)
//            + nu (Gamma(zeta) + tmp),  tmp = lap zeta on the interior, on
//               the ring c2 * (zeta(first interior) - zeta(ring))
//                                                              (bc_deriv_rel)
//            - nu4 (Gamma(tmp) + lap tmp)
//            + wind(y) (layer 0) + qf3                          (qf3 opt.)
//   dq    *= mask
//
// where J(a, b) is qg-node's +J Arakawa bracket (the msqg -J bracket with
// its arguments swapped), zero on the ring, as are lap and beta, and Gamma
// the vertical stretching with the (nl-1, M) y-profile s. At nl = 1 it is
// rhs_pv_barotropic (qg_barotropic.h:16-29): dq = (-J(psi, q) - beta term
// - fric q + wind + nu lap q) * mask, with neither psi nor q masked.
//
// Design: one block per column strip, marching down y (the design of K1,
// csrc/fused_rhs.cu). A block of TX = 128 threads owns TX vertex columns and
// SY = 32 rows for all nl layers; thread t is column x0 + t. The grid has
// (M - 2) / TX + 1 strips across and (M - 2) / SY + 1 down, and the last
// strip of each keeps the remainder, so at M = 2049 = 16 * 128 + 1 the last
// column strip owns 129 columns (the extra one, ring column M - 1, goes to
// one more lane) and the last row strip 33 rows: 16 x 64 = 1024 blocks,
// about two waves at 4 blocks an SM. Rings of whole rows (all layers of a row
// together) in shared memory: the raw input rows of psi and the mask, RR = 3
// rows; p = psi * mask, RP = 8 rows on a 3-column halo; zeta on 2 columns,
// RZ = 6 rows; tmp on 1 column, RM = 4 rows; pp and topo, when present,
// RQ = 5 rows on 3 columns. Step s of the
// march computes zeta row s, tmp row s - 2 and the outputs of row s - 4,
// then multiplies raw row s + 2 by its mask into the p ring: every stage
// reads only rows that an earlier step wrote, so a step has ONE barrier,
// at its end. The raw rows arrive by cp.async, row s + 4 issued in step s
// (two steps before its masking), pp and topo row s - 1 in step s. A strip
// runs SY + 6 steps: the y-halo is paid at its two ends only, the x-halo is
// (TX + 6) / TX = 1.05, and no node is computed twice inside a strip. The
// halo columns of every stage go to lanes of different warps. nl = 4, the
// configurations' depth, is a template case whose layer loops unroll and
// whose outputs are stored after all of the node's shared loads; a loop over
// a run-time nl serves nl = 2 .. 8 (tools/k5_variants.py times the two, and
// the other choices here, against each other). Each thread walks the layers
// of its node in order and carries the interface Jacobian Jd_l, the
// neighbourhoods of p_l+1 and pp_l+1 and the profile s_l to layer l + 1 in
// registers. The per-node arithmetic is that of the plain version; the two
// differ in the order of a few sums only. The scalars are rounded to T on
// the host.
//
// Where it could go wrong, and how the march meets it:
//  1. The ring is inside the array: global row and column 0 and M - 1. The
//     ring rules read the parent's first interior node (zeta from p, tmp
//     from zeta, less zeta's own ring value), which lies in the same row or
//     in the row beside it: zeta row 0 reads p row 1 (masked one step
//     before), zeta row M - 1 reads p row M - 2, tmp row 0 zeta rows 0 and 1,
//     tmp row M - 1 zeta rows M - 2 and M - 1, all written in earlier steps.
//     Corners are 0. The ring's outputs take no bracket, beta or lap.
//  2. M is odd, so rows start on any 4-byte boundary. A raw row is copied
//     COPY_BYTES at a time: at 4 bytes (f32) or 8 (f64) one element a copy;
//     wider copies start V-aligned in the source, the row lying shifted by
//     the source's misalignment in its raw slot and unshifted in the p ring.
//  3. A cp.async cannot multiply: the mask rides in the raw ring as one more
//     plane and every thread masks its columns of raw row s + 2 in step s,
//     after the barrier that made the row visible. The outputs take their
//     mask from device memory (the copy brought it into the caches), which
//     keeps every nl <= 8 within a block's shared memory in both types.
//  4. Slots: a ring has one slot for every row that one step touches (reads,
//     writes or has in flight), counted in the constants below.
//  5. The wall code (the ring rules, the inner-node tests, nodes outside the
//     array) runs in strips whose stages reach the ring only; there shared
//     memory is zeroed when the block starts. Interior strips run none of it.
//  6. The biharmonic stacks three Laplacians on p: at N = 2048 each
//     multiplies by ~8/delta^2, so f32 cancellation, not the index logic,
//     sets the f32 tolerance of the comparison.
//
// Bound. At 2048^2 x 4 in f32 (no pp, topo or qf3) the compulsory traffic is
// psi and the mask in and dq out, 9 * 2049^2 * 4 B = 151 MB, 45 us at
// 3.35 TB/s; about 90 FP32 operations per node and layer (fused_node_rhs.
// bound_work counts them), 23 us at 67 TFLOP/s: bytes bound it. What this
// design spends beyond them is instruction issue: an interior output-layer
// reads about 23 values of shared memory and does about 100 FP32
// operations; the zeta, tmp and masking stages add about 16 loads. The
// copies, masking and barriers alone take about a third of the kernel's
// time (tools/k5_variants.py); chip_smoke.py measures the distance from
// the bound.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int TX = 128;          // columns of a strip
constexpr int NTH = TX;          // threads: one a column
constexpr int SY = 32;           // output rows of a strip
constexpr int MAXNL = 8;         // most layers the kernel takes
constexpr int COPY_BYTES = 4;    // bytes of one cp.async of a raw row (8
                                 // and 16 were no faster, k5_variants)
constexpr int XH = 3;            // p halo columns
constexpr int PW = TX + 2 * XH;  // p ring row:   col c = x0 - 3 + c
constexpr int ZW = TX + 4;       // zeta ring row: col c = x0 - 2 + c
constexpr int MW = TX + 2;       // tmp ring row:  col c = x0 - 1 + c
// Ring rows. At step s: raw rows s + 2 (masked), s + 3 (landing), s + 4
// (issued); p rows s - 5 .. s + 1 read and s + 2 written; zeta rows s - 5 ..
// s - 1 read and s written; tmp rows s - 5 .. s - 3 read and s - 2 written;
// pp and topo rows s - 5 .. s - 3 read, s - 2 landing, s - 1 issued.
constexpr int RR = 3, RP = 8, RZ = 6, RM = 4, RQ = 5;
constexpr int BX = 32, BY = 8;   // the barotropic kernel's block

// Order of the device pointers handed to the C entry points.
enum Ptr { PSI, MASK, WIND, S2, DQ, Q, PP, TOPO, QF3, NPTRS };

// The scalars of a launch, rounded to T once on the host, and flags for the
// terms that are on.
template <typename T>
struct Params {
  int M, nl, has_nu, has_nu4;
  T id2, i12d2, i2d, beta, nu, nu4, fric, topo_fac, c2;
  T idh0[MAXNL], idh1[MAXNL];
};

template <typename T>
struct Fields {
  const T *psi, *mask, *wind, *s2, *q, *pp, *topo, *qf3;
  T* dq;
};

// Elements of one raw copy, and the width of a raw ring row: room for the
// shift of a row whose source is not V-aligned.
__host__ __device__ constexpr int vlen(int itemsize) {
  return COPY_BYTES > itemsize ? COPY_BYTES / itemsize : 1;
}
__host__ __device__ constexpr int raw_width(int itemsize) {
  return (PW + vlen(itemsize) - 1 + vlen(itemsize) - 1) / vlen(itemsize)
         * vlen(itemsize);
}

// Shared memory of one block, in elements: the raw ring first (its rows are
// aligned for the widest copy), then p, zeta, tmp, pp, topo.
size_t smem_cells(int nl, int itemsize, bool has_pg, bool has_topo) {
  if (nl < 2) return 0;
  return (size_t)(nl + 1) * RR * raw_width(itemsize)
       + (size_t)nl * (RP * PW + RZ * ZW + RM * MW)
       + (has_pg ? (size_t)RQ * nl * PW : 0) + (has_topo ? (size_t)RQ * PW : 0);
}

__device__ __forceinline__ int slot(int r, int R) {
  return (r + 8 * R) % R;    // rows from -8 on
}

__device__ __forceinline__ bool inner(int g, int M) {
  return g >= 1 && g <= M - 2;
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

// The misalignment, in elements of V, of the source element row + off.
template <typename T, int V>
__device__ __forceinline__ int shift(const T* row, int off) {
  if constexpr (V == 1)
    return 0;
  else
    return static_cast<int>(
        (reinterpret_cast<uintptr_t>(row) / sizeof(T) + off) & (V - 1));
}

// The eight neighbours of a node.
template <typename T>
struct Nb {
  T e, w, n, s, ne, nw, se, sw;
};

// Neighbours of column o of the rows m (y - 1), c and p (y + 1).
template <typename T>
__device__ __forceinline__ Nb<T> nb3(const T* m, const T* c, const T* p,
                                     int o) {
  return {c[o + 1], c[o - 1], p[o],     m[o],
          p[o + 1], p[o - 1], m[o + 1], m[o - 1]};
}

// The msqg -J(p, q) 12-point Arakawa bracket (ops/ghost.arakawa_mjac_g);
// qg-node's +J(a, b) is mjac(b, a).
template <typename T>
__device__ __forceinline__ T mjac(const Nb<T>& p, const Nb<T>& q, T i12d2) {
  const T j = (q.e - q.w) * (p.n - p.s) + (q.s - q.n) * (p.e - p.w)
            + q.e * (p.ne - p.se) - q.w * (p.nw - p.sw)
            - q.n * (p.ne - p.nw) + q.s * (p.se - p.sw)
            + p.n * (q.ne - q.nw) - p.s * (q.se - q.sw)
            - p.e * (q.ne - q.se) + p.w * (q.nw - q.sw);
  return j * i12d2;
}

// The 5-point Laplacian of column o, rows m below and p above.
template <typename T>
__device__ __forceinline__ T lap3(const T* m, const T* c, const T* p, int o,
                                  T id2) {
  return ((((c[o + 1] + c[o - 1]) + p[o]) + m[o]) - T(4) * c[o]) * id2;
}

// Gamma(a)[l] at one node: a points at layer l's node, layers `plane`
// apart; s0 and s1 the profiles of the interfaces above and below.
template <typename T>
__device__ __forceinline__ T gamma_at(const T* a, int plane, int l, int nl,
                                      T s0, T s1, const Params<T>& p) {
  T g = T(0);
  if (l > 0) g = s0 * (a[-plane] - a[0]) * p.idh0[l];
  if (l < nl - 1) g -= s1 * (a[0] - a[plane]) * p.idh1[l];
  return g;
}

// The layered tendency, nl >= 2: NL = 4 unrolled, NL = 0 a loop over p.nl.
// COUPLED = false compiles out pp, topo and qf3 (the uncoupled launch keeps
// its registers); COUPLED = true takes them from the non-null pointers of F.
template <typename T, int NL, bool COUPLED>
__global__ void __launch_bounds__(NTH, COUPLED ? 3 : 4)
node_kernel(const Fields<T> F, const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int V = vlen(sizeof(T)), RW = raw_width(sizeof(T)), CW = RW / V;
  constexpr int NLA = NL > 0 ? NL : 1;
  const int M = p.M, nl = NL > 0 ? NL : p.nl, npl = nl + 1;
  const bool has_pg = COUPLED && F.pp != nullptr;
  const bool has_topo = COUPLED && F.topo != nullptr;
  const bool has_qf3 = COUPLED && F.qf3 != nullptr;
  T* sr = reinterpret_cast<T*>(smem_raw);           // raw   (RR, nl+1, RW)
  T* sp = sr + RR * npl * RW;                        // p     (RP, nl, PW)
  T* sz = sp + RP * nl * PW;                         // zeta  (RZ, nl, ZW)
  T* sm = sz + RZ * nl * ZW;                         // tmp   (RM, nl, MW)
  T* sq = sm + RM * nl * MW;                         // pp    (RQ, nl, PW)
  T* st = sq + (has_pg ? RQ * nl * PW : 0);          // topo  (RQ, 1, PW)
  const int ncells = static_cast<int>(st - sr) + (has_topo ? RQ * PW : 0);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * SY;
  const int y1 = blockIdx.y + 1 == gridDim.y ? M : y0 + SY;  // rows [y0, y1)
  const bool extra = x0 + TX == M - 1;    // this strip owns column M - 1 too
  const size_t MM = (size_t)M * M;
  const T id2 = p.id2, i12d2 = p.i12d2, c2 = p.c2;
  // a strip whose stages reach the ring (hazard 5)
  const bool edge = x0 <= 2 || x0 + TX + 1 >= M - 1 || y0 <= 2
                 || y1 + 1 >= M - 1;
  const int rlo = max(y0 - 3, 0), rhi = min(y1 + 2, M - 1);  // input rows

  if (edge) {
    for (int k = tid; k < ncells; k += NTH) sr[k] = T(0);
    __syncthreads();
  }

  // the copies of raw row r: the nl planes of psi, then the mask
  auto issue = [&](int r) {
    if (r < rlo || r > rhi) return;
    T* dst = sr + slot(r, RR) * npl * RW;
    for (int k = tid; k < npl * CW; k += NTH) {
      const int l = k / CW, j = k - l * CW;
      const T* src = (l < nl ? F.psi + l * MM : F.mask) + (size_t)r * M;
      const int col = x0 - XH - shift<T, V>(src, x0 - XH) + j * V;
      T* d = dst + l * RW + j * V;
      if (col >= 0 && col + V <= M) {
        cp_async<int(V * sizeof(T))>(d, src + col);
      } else if constexpr (V > 1) {
        for (int e = 0; e < V; ++e)
          if (col + e >= 0 && col + e < M)
            cp_async<int(sizeof(T))>(d + e, src + col + e);
      }
    }
  };
  // the copies of pp and topo row r (read by the outputs of rows r - 1 ..
  // r + 1) into their rings
  auto issue_q = [&](int r) {
    if (r < max(y0 - 1, 0) || r > min(y1, M - 1)) return;
    const int np = (has_pg ? nl : 0) + (has_topo ? 1 : 0);
    for (int k = tid; k < np * PW; k += NTH) {
      const int l = k / PW, c = k - l * PW, gx = x0 - XH + c;
      if (gx < 0 || gx >= M) continue;
      const size_t node = (size_t)r * M + gx;
      if (has_topo && l == np - 1)
        cp_async<int(sizeof(T))>(st + slot(r, RQ) * PW + c, F.topo + node);
      else
        cp_async<int(sizeof(T))>(sq + (slot(r, RQ) * nl + l) * PW + c,
                                 F.pp + l * MM + node);
    }
  };
  // p = psi * mask of row r (hazard 3); the six halo columns go to lanes
  // 31 and 30 of different warps
  auto mask_row = [&](int r) {
    if (r < rlo || r > rhi) return;
    const T* raw = sr + slot(r, RR) * npl * RW;
    T* dst = sp + slot(r, RP) * nl * PW;
    const size_t node = (size_t)r * M;
    const int am = shift<T, V>(F.mask + node, x0 - XH);
    auto col = [&](int c) {
      if (edge && (x0 - XH + c < 0 || x0 - XH + c >= M)) {
        for (int l = 0; l < nl; ++l) dst[l * PW + c] = T(0);
        return;
      }
      const T m = raw[nl * RW + am + c];
      if constexpr (NL > 0) {
        T v[NL];
#pragma unroll
        for (int l = 0; l < NL; ++l)
          v[l] = raw[l * RW + shift<T, V>(F.psi + l * MM + node, x0 - XH) + c]
               * m;
#pragma unroll
        for (int l = 0; l < NL; ++l) dst[l * PW + c] = v[l];
      } else {
        for (int l = 0; l < nl; ++l)
          dst[l * PW + c] =
              raw[l * RW + shift<T, V>(F.psi + l * MM + node, x0 - XH) + c]
              * m;
      }
    };
    col(tid);
    const int e = (31 - lane) * 4 + warp;
    if (lane >= 30 && e < PW - TX) col(TX + e);
  };

  // f = lap(parent) at column c of row gy, all layers: f's rows W wide with
  // an h-column halo, the parent's PWP wide with a halo one column wider,
  // so f's column c is the parent's c + 1; in a wall strip the ring rule
  // (hazard 1): c2 * (parent's first interior node - parent's own node if
  // REL), corners 0, nothing outside the array
  auto lap_cell = [&](T* f, const T* par, int W, int R, int PWP, int RPAR,
                      int h, int gy, int c, auto rel) {
    constexpr bool REL = decltype(rel)::value;
    const int gx = x0 - h + c, o = c + 1;
    const T* pm = par + slot(gy - 1, RPAR) * nl * PWP;
    const T* p0 = par + slot(gy, RPAR) * nl * PWP;
    const T* pu = par + slot(gy + 1, RPAR) * nl * PWP;
    T* f0 = f + slot(gy, R) * nl * W + c;
    if (!edge || (inner(gy, M) && inner(gx, M))) {
      if constexpr (NL > 0) {
        T v[NL];
#pragma unroll
        for (int l = 0; l < NL; ++l) v[l] = lap3(pm, p0, pu, l * PWP + o, id2);
#pragma unroll
        for (int l = 0; l < NL; ++l) f0[l * W] = v[l];
      } else {
        for (int l = 0; l < nl; ++l) f0[l * W] = lap3(pm, p0, pu, l * PWP + o,
                                                      id2);
      }
      return;
    }
    if (gx < 0 || gx >= M) return;
    const bool ry = gy == 0 || gy == M - 1, rx = gx == 0 || gx == M - 1;
    // the first interior node: beside it in the row, or in the row inside
    const T* fr = rx ? p0 : gy == 0 ? pu : pm;
    const int fo = o + (rx ? (gx == 0 ? 1 : -1) : 0);
    for (int l = 0; l < nl; ++l) {
      T v = T(0);
      if (ry != rx)
        v = c2 * (REL ? fr[l * PWP + fo] - p0[l * PWP + o] : fr[l * PWP + fo]);
      f0[l * W] = v;
    }
  };
  // zeta row gy: thread t takes column x0 + t, the four halo columns go to
  // lane 31 of warps 0 .. 3
  auto zeta_row = [&](int gy) {
    lap_cell(sz, sp, ZW, RZ, PW, RP, 2, gy, tid + 2, std::false_type());
    if (lane == 31)
      lap_cell(sz, sp, ZW, RZ, PW, RP, 2, gy, warp < 2 ? warp : TX + warp,
               std::false_type());
  };
  // tmp row gy: the two halo columns on lane 31 of warps 0 and 1
  auto tmp_row = [&](int gy) {
    lap_cell(sm, sz, MW, RM, ZW, RZ, 1, gy, tid + 1, std::true_type());
    if (lane == 31 && warp < 2)
      lap_cell(sm, sz, MW, RM, ZW, RZ, 1, gy, warp == 0 ? 0 : TX + 1,
               std::true_type());
  };

  // the tendency at node (g, x0 + j), all layers; IN: an inner node
  auto out_cell = [&](int g, int j, auto in_c) {
    constexpr bool IN = decltype(in_c)::value;
    const int cp = j + XH, cz = j + 2, cm = j + 1;
    const T* pm = sp + slot(g - 1, RP) * nl * PW + cp;
    const T* p0 = sp + slot(g, RP) * nl * PW + cp;
    const T* pu = sp + slot(g + 1, RP) * nl * PW + cp;
    const T* zm = sz + slot(g - 1, RZ) * nl * ZW + cz;
    const T* z0 = sz + slot(g, RZ) * nl * ZW + cz;
    const T* zu = sz + slot(g + 1, RZ) * nl * ZW + cz;
    const T* mm = sm + slot(g - 1, RM) * nl * MW + cm;
    const T* m0 = sm + slot(g, RM) * nl * MW + cm;
    const T* mu = sm + slot(g + 1, RM) * nl * MW + cm;
    const T* qm = sq + slot(g - 1, RQ) * nl * PW + cp;
    const T* q0 = sq + slot(g, RQ) * nl * PW + cp;
    const T* qu = sq + slot(g + 1, RQ) * nl * PW + cp;
    const size_t o = (size_t)g * M + x0 + j;
    const T mask = F.mask[o];
    [[maybe_unused]] T res[NLA];
    T jprev = T(0), sprev = T(0);
    Nb<T> pn, qn;
    if constexpr (IN) {
      pn = nb3(pm, p0, pu, 0);
      if (has_pg) qn = nb3(qm, q0, qu, 0);
    }
#pragma unroll
    for (int l = 0; l < nl; ++l) {
      const T scur = l < nl - 1 ? F.s2[l * M + g] : T(0);
      const T* Z = z0 + l * ZW;
      const T* Tm = m0 + l * MW;
      T acc = T(0);
      if constexpr (IN) {
        const Nb<T> zn = nb3(zm, z0, zu, l * ZW);
        acc = -mjac(zn, pn, i12d2);
        if (has_pg) acc -= mjac(zn, qn, i12d2);
        acc -= p.beta * (pn.e - pn.w) * p.i2d;
        T jnext = T(0);
        Nb<T> pup = pn, qup = qn;
        if (l < nl - 1) {
          pup = nb3(pm, p0, pu, (l + 1) * PW);
          jnext = mjac(pup, pn, i12d2);
          if (has_pg) {
            qup = nb3(qm, q0, qu, (l + 1) * PW);
            jnext += mjac(pup, qn, i12d2) + mjac(qup, pn, i12d2);
          }
          acc -= scur * jnext * p.idh1[l];
        }
        if (l > 0) acc += sprev * jprev * p.idh0[l];
        jprev = jnext;
        if (has_topo && l == nl - 1) {
          const T* tm = st + slot(g - 1, RQ) * PW + cp;
          const T* t0 = st + slot(g, RQ) * PW + cp;
          const T* tu = st + slot(g + 1, RQ) * PW + cp;
          acc -= mjac(nb3(tm, t0, tu, 0), pn, i12d2) * p.topo_fac;
        }
        pn = pup;
        qn = qup;
      }
      if (l == nl - 1) acc -= p.fric * Z[0];
      if (p.has_nu) {
        acc += p.nu * gamma_at(Z, ZW, l, nl, sprev, scur, p);
        acc += p.nu * Tm[0];
      }
      if (p.has_nu4) {
        T bih = gamma_at(Tm, MW, l, nl, sprev, scur, p);
        if constexpr (IN) bih += lap3(mm, m0, mu, l * MW, id2);
        acc -= p.nu4 * bih;
      }
      if (l == 0) acc += F.wind[g];
      if (has_qf3) acc += F.qf3[l * MM + o];
      if constexpr (NL > 0)
        res[l] = acc * mask;
      else
        F.dq[l * MM + o] = acc * mask;
      sprev = scur;
    }
    if constexpr (NL > 0) {
#pragma unroll
      for (int l = 0; l < NL; ++l) F.dq[l * MM + o] = res[l];
    }
  };

  // prologue: raw rows s0 - 1 .. s0 + 1 masked into the p ring, row s0 + 2
  // landed and s0 + 3 in flight; step s then issues row s + 4, masks row
  // s + 2 and waits for row s + 3
  const int s0 = y0 - 2;
  for (int r = s0 - 1; r <= s0 + 1; ++r) issue(r);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int r = s0 - 1; r <= s0 + 1; ++r) mask_row(r);
  __syncthreads();
  issue(s0 + 2);
  cp_async_commit();
  issue(s0 + 3);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int gx = x0 + tid;
  for (int s = s0; s <= y1 + 3; ++s) {
    issue(s + 4);
    if (has_pg || has_topo) issue_q(s - 1);
    cp_async_commit();

    if (s <= y1 + 1 && s >= 0 && s < M) zeta_row(s);
    const int t = s - 2;
    if (t >= y0 - 1 && t <= y1 && t >= 0 && t < M) tmp_row(t);
    const int g = s - 4;
    if (g >= y0 && g < y1) {
      if (!edge || (inner(g, M) && inner(gx, M)))
        out_cell(g, tid, std::true_type());
      else if (gx < M)
        out_cell(g, tid, std::false_type());
      if (extra && tid == NTH - 33) out_cell(g, TX, std::false_type());
    }
    mask_row(s + 2);

    // raw row s + 3, masked in the next step, has landed: the step's one
    // barrier
    cp_async_wait<1>();
    __syncthreads();
  }
  cp_async_wait<0>();
}

// The barotropic tendency, nl = 1: one thread a node.
template <typename T>
__global__ void __launch_bounds__(BX * BY)
baro_kernel(const Fields<T> F, const Params<T> p) {
  const int M = p.M;
  const int gx = blockIdx.x * BX + threadIdx.x;
  const int gy = blockIdx.y * BY + threadIdx.y;
  if (gy >= M || gx >= M) return;
  const size_t node = (size_t)gy * M + gx;
  const T* Q = F.q + node;
  T acc = T(0);
  const bool in = inner(gy, M) && inner(gx, M);
  if (in) {
    const T* P = F.psi + node;
    const Nb<T> pn = nb3(P - M, P, P + M, 0);
    acc = -mjac(nb3(Q - M, Q, Q + M, 0), pn, p.i12d2)
        - p.beta * (pn.e - pn.w) * p.i2d;
  }
  acc -= p.fric * Q[0];
  acc += F.wind[gy];
  if (in && p.has_nu) acc += p.nu * lap3(Q - M, Q, Q + M, 0, p.id2);
  F.dq[node] = acc * F.mask[node];
}

template <typename T>
int run(void (*kernel)(const Fields<T>, const Params<T>), const Fields<T>& F,
        const Params<T>& p, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.M - 2) / TX + 1, (p.M - 2) / SY + 1), block(NTH);
  kernel<<<grid, block, smem, stream>>>(F, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* const* ptrs, int M, int nl, const double* scal,
           const double* idh0, const double* idh1, void* stream) {
  if (nl < 1 || nl > MAXNL || M < 3) return (int)cudaErrorInvalidValue;
  if (!ptrs[PSI] || !ptrs[MASK] || !ptrs[WIND] || !ptrs[DQ]
      || (nl > 1 && !ptrs[S2]) || (nl == 1 && !ptrs[Q]))
    return (int)cudaErrorInvalidValue;
  Fields<T> F;
  F.psi = static_cast<const T*>(ptrs[PSI]);
  F.mask = static_cast<const T*>(ptrs[MASK]);
  F.wind = static_cast<const T*>(ptrs[WIND]);
  F.s2 = static_cast<const T*>(ptrs[S2]);
  F.q = static_cast<const T*>(ptrs[Q]);
  F.pp = static_cast<const T*>(ptrs[PP]);
  F.topo = static_cast<const T*>(ptrs[TOPO]);
  F.qf3 = static_cast<const T*>(ptrs[QF3]);
  F.dq = static_cast<T*>(const_cast<void*>(ptrs[DQ]));
  Params<T> p;
  const double delta = scal[0];
  p.M = M;
  p.nl = nl;
  p.id2 = T(1.0 / (delta * delta));
  p.i12d2 = T(1.0 / (12.0 * delta * delta));
  p.i2d = T(1.0 / (2.0 * delta));
  p.beta = T(scal[1]);
  p.nu = T(scal[2]);
  p.nu4 = T(scal[3]);
  p.fric = T(scal[4]);
  p.topo_fac = T(scal[5]);
  p.c2 = T(scal[6]);
  p.has_nu = scal[2] != 0.0;
  p.has_nu4 = scal[3] != 0.0;
  for (int l = 0; l < MAXNL; ++l) {
    p.idh0[l] = T(l < nl ? idh0[l] : 0.0);
    p.idh1[l] = T(l < nl ? idh1[l] : 0.0);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nl == 1) {
    const dim3 grid((M + BX - 1) / BX, (M + BY - 1) / BY), block(BX, BY);
    baro_kernel<T><<<grid, block, 0, s>>>(F, p);
    return (int)cudaGetLastError();
  }
  const size_t smem =
      sizeof(T) * smem_cells(nl, sizeof(T), F.pp != nullptr, F.topo != nullptr);
  const bool coupled = F.pp || F.topo || F.qf3;
  if (nl == 4)
    return coupled ? run(node_kernel<T, 4, true>, F, p, smem, s)
                   : run(node_kernel<T, 4, false>, F, p, smem, s);
  return coupled ? run(node_kernel<T, 0, true>, F, p, smem, s)
                 : run(node_kernel<T, 0, false>, F, p, smem, s);
}

}  // namespace

extern "C" {

// Most layers the kernel takes.
int node_rhs_max_nl() { return MAXNL; }

// Dynamic shared memory of one block, in bytes, for an option set.
long long node_rhs_smem_bytes(int nl, int itemsize, int has_pg,
                              int has_topo) {
  return (long long)itemsize
       * (long long)smem_cells(nl, itemsize, has_pg != 0, has_topo != 0);
}

// ptrs = device pointers in the order of `Ptr` (psi, mask, wind, s2, dq, q,
// pp, topo, qf3), null where a field is absent: s2 the (nl-1, M) profile
// (nl > 1), q the PV (nl = 1 only), pp, topo and qf3 the optional fields
// (nl > 1). scal = {delta, beta, nu, nu4, fric, topo_fac, c2}; idh0/idh1
// host arrays of nl doubles. Launches on `stream` and returns the CUDA
// error code of the launch (0 on success).
int node_rhs_f32(const void* const* ptrs, int M, int nl, const double* scal,
                 const double* idh0, const double* idh1, void* stream) {
  return launch<float>(ptrs, M, nl, scal, idh0, idh1, stream);
}

int node_rhs_f64(const void* const* ptrs, int M, int nl, const double* scal,
                 const double* idh0, const double* idh1, void* stream) {
  return launch<double>(ptrs, M, nl, scal, idh0, idh1, stream);
}

const char* node_rhs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
