// Fused passive-tracer tendency for Hopper (sm_90a): kernel K2 of the port.
//
// Replaces the Pallas TPU kernel `_tracer_kernel`
// (msom_tpu/models/pallas_rhs.py, entry `tracer_fused`), walled and doubly
// periodic.
// For the nl * nptr tracer planes c_k, k = l * nptr + j (the flattening of
// the (nl, nptr, N, N) state: layer l = k / nptr, tracer j = k % nptr), it
// computes in one pass over device memory
//
//   dtr_k = -J(psi_l, c_k) + iPe_j * lap(c_k) + ir_j * (relax_k - c_k)
//
// (ptr_rhs, msqg/qg.h:573-588), or -ir_j * c_k without a relaxation field.
// -J is the 12-point Arakawa bracket. psi has Dirichlet ghosts (ghost =
// -interior, corners +interior), the tracers Neumann ghosts (ghost =
// +interior on both axes, corners included). In the periodic run (a kernel
// of its own, `tracer_kernel<.., true>`) both wrap (pallas_rhs.py:797-799).
//
// Design: one block per column strip of one layer, marching down y (the
// design of K1, csrc/fused_rhs.cu, for a 3 x 3 stencil with no derived
// field). A block of TX = 128 threads owns TX columns and `rows` rows of
// layer l = blockIdx.z for all nptr tracers of that layer; thread t is
// column x0 + t. The caller gives the strip height, the grid and the
// shared memory (models/fused_tracer.py `launch_geometry`: 32 rows, so
// 16 x 64 x 4 = 4096 blocks at N = 2048, nl = 4, about 5.2 waves at 6
// blocks an SM (80 registers)); the launch refuses a grid that does not
// cover the planes exactly, the last strip of each direction keeping the
// remainder (N = 257: one column, one row), or too little shared memory.
// A ring of R = 8 whole rows in shared memory holds, for each row, psi_l
// and then c_l,0 .. c_l,nptr-1, each on an XH = 4 column x-halo (one
// column is read; four keep the 16-byte chunks aligned): 13,056 B a block
// at nptr = 2 in f32. The rows arrive by cp.async, 16-byte chunks where N
// and the pointers allow, else one element a copy, issued DEPTH = 3 steps
// before their first use: step s issues row s + 4, computes output row s
// from rows s - 1 .. s + 1 and waits for row s + 2, so a step has ONE
// barrier, at its end. A strip of 32 rows loads 34 (34 / 32 = 1.06) of
// TX + 2 columns (TX + 8 = 1.06 with the aligned chunks), and psi_l's
// neighbourhood is read once for all tracers of the layer. The relaxation
// field, read once, comes straight from device memory in the output stage
// with a streaming load. nptr = 2, the coupled configurations' count, is a
// template case whose tracer loop unrolls and whose outputs are stored
// after all of the cell's shared loads; a loop over a run-time nptr serves
// 1 to MAXTR = 16. The strips that touch a wall run a march of their own
// (`march<.., true>`); the others run one with no wall code.
// tools/k2_variants.py times each of these choices against its
// alternatives. The per-cell arithmetic is that of the plain version; the
// scalars are rounded to T on the host.
//
// Where it could go wrong, and how the march meets it:
//  1. The (l, j) order of the flattened planes (the layer of plane k is
//     k / nptr, its coefficients those of k % nptr) and the two ghost signs;
//     chip_smoke.py and tests/test_torch_cuda.py hold the kernel against the
//     plain version with distinct per-tracer coefficients and a relaxation
//     field on and off.
//  2. Input ghosts are never fetched. Ghost rows: after its own copy of row
//     0 or N - 1 has landed (cp.async.wait_group makes a thread's own copies
//     visible to it), the thread that copied it writes ghost row -1 or N
//     beside it, Dirichlet (-row) for psi, Neumann (+row) for the tracers.
//     Ghost columns never enter shared memory: the thread of column 0 or
//     N - 1 replaces its west or east neighbours by sign * its own column's
//     values of the three rows (`wall_x`); at a corner that value is the
//     ghost row's, so the corner composes x after y (+interior for both
//     fields).
//  3. Slots: at step s the ring holds rows s - 1 .. s + 1 (read), s + 2
//     (landing, its ghosts written at the step's end), s + 3 and s + 4
//     (issued); the ghost row N, written with row N - 1 = s + 2, takes row
//     N's slot, which is never copied: DEPTH + 3 = 6 rows at least, one
//     slot each (tools/strip_emulation.py shows 5 going wrong). R = 8, a
//     power of two, makes the slot a mask and read 2% faster than 6
//     (tools/k2_variants.py).
//  4. Cells outside the grid (partial strips) are never fetched and feed no
//     stored output: a thread past column N - 1 computes and stores nothing
//     that is read.
//  5. The wall code runs in strips that touch a wall only, by a test that is
//     uniform over the block; interior strips run none of it.
//  6. Periodic: no ghost is written. The strips at an edge (`march<..,
//     WRAP>`) fetch their rows modulo N and their x-halo chunks from the
//     other end of the row; a chunk starts at a multiple of V and N % V == 0,
//     so it wraps whole (else one element a copy). A strip that holds the
//     whole width or height (N <= 128, N <= 32) fetches its wrapped halo as
//     inputs into ring slots of their own: rows are slotted by their
//     unwrapped index, -1 .. N. The other strips run the interior march.
//     N >= 4: the halo wraps once.
//  7. Rows mode (the TPU kernel's SMEM `row0`, pallas_rhs.py:778-795): the
//     output rows [row0, row0 + ny) of a shard of a rows decomposition. The
//     march keeps global row indices, so the wall rules, the edge strips
//     and the slots are those of the whole grid; only the address of a row
//     of psi and the tracers changes: they come as the shard with the 8-row
//     halo slabs of its y-neighbours (parallel/halo.ext_rows8, wrapped
//     when periodic, which the WRAP march then reads in place of the
//     modulo), global row r at row r - row0 + 8. A wall shard's slab is
//     never read. relax stays whole, read at the global row; dtr is the
//     shard's. Rows mode is the compile-time constant EXT: this file builds
//     the whole-domain kernels, csrc/fused_tracer_rows.cu (which defines
//     FUSED_TRACER_ROWS and includes it) the rows kernels, a library of
//     their own with the same C entries. As a run-time branch the rows
//     addressing slowed the whole-domain kernel 4-8% on one H100 (PERF.md,
//     PR 15).
//
// Bound. Bytes: psi (nl planes) and the tracers (nl * nptr) read, dtr
// (nl * nptr) written, the relaxation field (nl * nptr) read where there is
// one; at 2048^2 x 4 with 2 tracers in f32, 20 planes = 335 MB, about 100 us
// at 3.35 TB/s. The arithmetic is about 45 operations per cell and plane
// (one bracket, one Laplacian, the relaxation), about 20 us at 67 TFLOP/s:
// bytes bound it. The march reads each input once but for its halos (1.13
// of the input planes, 361 MB moved in all), and keeps three rows of every
// plane in flight per block, so that the copies, not one load a thread, set
// the rate; the copies and stores without the arithmetic take about 0.9 of
// the kernel's time (tools/k2_variants.py).

#include <cuda_runtime.h>

#include <type_traits>

#ifndef FUSED_TRACER_ROWS
#define FUSED_TRACER_ROWS 0
#endif

namespace {

constexpr bool EXT = FUSED_TRACER_ROWS;  // the rows mode (hazard 7)

constexpr int TX = 128;            // columns of a strip
constexpr int NTH = TX;            // threads: one a column
constexpr int MAXTR = 16;          // most tracers per layer
constexpr int XH = 4;              // ring x-halo (1 read, 4 for 16-B chunks)
constexpr int PW = TX + 2 * XH;    // ring row of a plane: col c = x0 - 4 + c
constexpr int DEPTH = 3;           // steps a row is issued before first use
constexpr int R = 8;               // ring rows, DEPTH + 3 at least (hazard 3)
static_assert(R >= DEPTH + 3, "the ring's rows (hazard 3)");

template <typename T>
struct Params {
  int N, nptr, vec, rows;
  int row0, ny;        // rows mode: the output rows [row0, row0 + ny)
  T id2, i12d2;
  T iPe[MAXTR], ir[MAXTR];
};

template <typename T>
struct Fields {
  const T *psi, *tr, *relax;
  T* dtr;
};

// Shared memory of one block, in elements: R rows of psi_l and the nptr
// tracers of the layer.
size_t smem_cells(int nptr) { return (size_t)R * (1 + nptr) * PW; }

__device__ __forceinline__ int slot(int r) {
  return (unsigned)(r + R) % R;    // rows from -1 on
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

// The chunks of V elements of a ring row that hold a column of
// [x0 - 1, x0 + TX]: chunk J0 + i, i < CW, starts at column x0 - XH +
// (J0 + i) * V, and lies wholly inside or outside the grid (x0 - XH and N
// are multiples of V).
template <int V>
struct Chunks {
  static constexpr int J0 = (XH - 1) / V;
  static constexpr int CW = (XH + TX) / V - J0 + 1;
};

// Issue the copies of input row r of the np planes (psi_l, then the
// tracers of layer l, NN apart) into its ring slot.
// WRAP (hazard 6): row r and the columns taken modulo N. SLAB (rows mode,
// hazard 7): row r is row r - row0 + 8 of the slab tensors, whose planes
// are NN apart (NN the slab's plane there), and only the columns wrap.
template <typename T, int V, bool WRAP, bool SLAB = false>
__device__ __forceinline__ void issue_row(T* ring, const T* __restrict__ psi,
                                          const T* __restrict__ tr, int np,
                                          int r, int x0, int N, size_t NN,
                                          int tid, int row0 = 0) {
  using C = Chunks<V>;
  T* dst = ring + slot(r) * np * PW;
  const int rw = SLAB ? r - row0 + 8
               : !WRAP ? r : r < 0 ? r + N : (r >= N ? r - N : r);
  const size_t ro = (size_t)rw * N;
  for (int k = tid; k < np * C::CW; k += NTH) {
    const int pl = k / C::CW, j = C::J0 + k - pl * C::CW;
    int gx = x0 - XH + j * V;
    if (WRAP) gx = gx < 0 ? gx + N : (gx >= N ? gx - N : gx);
    if (gx >= 0 && gx < N) {
      const T* src = (pl == 0 ? psi : tr + (pl - 1) * NN) + ro + gx;
      cp_async<int(V * sizeof(T))>(dst + pl * PW + j * V, src);
    }
  }
}

// The ghost rows that this thread's own copies of row r = 0 or N - 1 feed
// (hazard 2): row -1 and row N, -row for psi (plane 0), +row for the
// tracers. Runs after the thread's wait on row r, before the barrier that
// publishes it.
template <typename T, int V>
__device__ __forceinline__ void fix_row(T* ring, int np, int r, int x0,
                                        int N, int tid) {
  using C = Chunks<V>;
  const T* row = ring + slot(r) * np * PW;
  T* up = ring + slot(-1) * np * PW;
  T* dn = ring + slot(N) * np * PW;
  for (int k = tid; k < np * C::CW; k += NTH) {
    const int pl = k / C::CW, j = C::J0 + k - pl * C::CW;
    const int gx0 = x0 - XH + j * V;
    if (gx0 < 0 || gx0 >= N) continue;
    const T sign = pl == 0 ? T(-1) : T(1);
    for (int e = 0; e < V; ++e) {
      const int c = pl * PW + j * V + e;
      if (r == 0) up[c] = sign * row[c];
      if (r == N - 1) dn[c] = sign * row[c];
    }
  }
}

// The eight neighbours of a cell.
template <typename T>
struct Nb {
  T e, w, n, s, ne, nw, se, sw;
};

// Neighbours of the cell c points at; m and p point at the same column of
// the rows below (y - 1) and above (y + 1), whose own values are s and n.
template <typename T>
__device__ __forceinline__ Nb<T> nb3(const T* m, const T* c, const T* p, T s,
                                     T n) {
  return {c[1], c[-1], n, s, p[1], p[-1], m[1], m[-1]};
}

// The x-wall ghosts of the neighbourhood a of a cell in column gx (hazard
// 2): beside column 0 or N - 1 the ghost column is sign * the wall column,
// of the rows below, at and above, c the cell's own value; a corner takes
// the ghost row's value, so it composes x after y.
template <typename T>
__device__ __forceinline__ void wall_x(Nb<T>& a, T c, int gx, int N, T sign) {
  if (gx == 0) {
    a.w = sign * c;
    a.nw = sign * a.n;
    a.sw = sign * a.s;
  }
  if (gx == N - 1) {
    a.e = sign * c;
    a.ne = sign * a.n;
    a.se = sign * a.s;
  }
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

// The march of one strip, rows [y0, y1) of columns from x0, layer l.
// NPT = 2 unrolled, NPT = 0 a loop over p.nptr. WALLS = false compiles the
// wall code out, for the strips that touch no wall (hazard 5). WRAP: a
// periodic strip at an edge, no wall code, every row and column fetched
// modulo N (hazard 6).
template <typename T, int NPT, bool WALLS, bool WRAP = false>
__device__ __forceinline__ void march(const Fields<T>& F, const Params<T>& p,
                                      T* ring, int x0, int y0, int y1,
                                      int l) {
  static_assert(!(WALLS && WRAP), "a strip has walls or wraps");
  const int N = p.N, nptr = NPT > 0 ? NPT : p.nptr, np = 1 + nptr;
  const int tid = threadIdx.x;
  const size_t NN = (size_t)N * N;                 // relax: whole planes
  // psi and the tracers: whole planes, or in rows mode (hazard 7) the
  // shard's ny + 16 rows; dtr: the ny rows
  const int row0 = EXT ? p.row0 : 0;
  const size_t IN = EXT ? (size_t)(p.ny + 16) * N : NN;
  const size_t ON = EXT ? (size_t)p.ny * N : NN;
  const T* psi = F.psi + l * IN;
  const T* tr = F.tr + (size_t)l * nptr * IN;
  const T id2 = p.id2, i12d2 = p.i12d2;

  // f(std::integral_constant<int, V>) with this launch's copy width V
  auto with_v = [&](auto f) {
    if (p.vec)
      f(std::integral_constant<int, 16 / sizeof(T)>());
    else
      f(std::integral_constant<int, 1>());
  };
  // the copies of row r (the rows [y0 - 1, y1] that lie in the grid, all
  // of them with WRAP) and, once they have landed, the ghosts they feed
  auto load = [&](int r) {
    if ((!WRAP && (r < 0 || r >= N)) || r > y1) return;
    with_v([&](auto v) {
      issue_row<T, decltype(v)::value, WRAP, EXT>(ring, psi, tr, np, r, x0,
                                                  N, IN, tid, row0);
    });
  };
  auto fix = [&](int r) {
    if (!WALLS || !(r == 0 || r == N - 1) || r > y1) return;
    with_v([&](auto v) {
      fix_row<T, decltype(v)::value>(ring, np, r, x0, N, tid);
    });
  };

  // prologue: rows y0 - 1 .. y0 + 1 (read by the first step) in one group,
  // then rows y0 + 2 .. y0 + DEPTH a group each; step s then issues row
  // s + 1 + DEPTH and waits for row s + 2
  for (int r = y0 - 1; r <= y0 + 1; ++r) load(r);
  cp_async_commit();
  for (int r = y0 + 2; r <= y0 + DEPTH; ++r) {
    load(r);
    cp_async_commit();
  }
  cp_async_wait<DEPTH - 1>();
  for (int r = y0 - 1; r <= y0 + 1; ++r) fix(r);
  __syncthreads();

  const int gx = x0 + tid, ip = tid + XH;
  for (int s = y0; s < y1; ++s) {
    load(s + 1 + DEPTH);
    cp_async_commit();

    // the outputs of row s, all tracers of the layer
    const T* Pm = ring + slot(s - 1) * np * PW + ip;
    const T* P0 = ring + slot(s) * np * PW + ip;
    const T* Pp = ring + slot(s + 1) * np * PW + ip;
    Nb<T> pn = nb3(Pm, P0, Pp, Pm[0], Pp[0]);
    if constexpr (WALLS) wall_x(pn, P0[0], gx, N, T(-1));
    const size_t row = (size_t)s * N + gx;
    const size_t orow = (size_t)(s - row0) * N + gx;    // dtr, rows mode
    if constexpr (NPT > 0) {
      T res[NPT];
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const int o = (1 + j) * PW;
        const T cc = P0[o];
        Nb<T> cn = nb3(Pm + o, P0 + o, Pp + o, Pm[o], Pp[o]);
        if constexpr (WALLS) wall_x(cn, cc, gx, N, T(1));
        const T lap = (cn.e + cn.w + cn.n + cn.s - T(4) * cc) * id2;
        T tgt = -cc;
        if (F.relax != nullptr && gx < N)
          tgt += __ldcs(F.relax + l * nptr * NN + j * NN + row);
        res[j] = mjac(pn, cn, i12d2) + p.iPe[j] * lap + p.ir[j] * tgt;
      }
      if (gx < N) {
#pragma unroll
        for (int j = 0; j < NPT; ++j)
          F.dtr[EXT ? ((size_t)l * NPT + j) * ON + orow
                    : ((size_t)l * NPT + j) * NN + row] = res[j];
      }
    } else {
      for (int j = 0; j < nptr; ++j) {
        const int o = (1 + j) * PW;
        const T cc = P0[o];
        Nb<T> cn = nb3(Pm + o, P0 + o, Pp + o, Pm[o], Pp[o]);
        if constexpr (WALLS) wall_x(cn, cc, gx, N, T(1));
        const T lap = (cn.e + cn.w + cn.n + cn.s - T(4) * cc) * id2;
        const size_t k = ((size_t)l * nptr + j) * NN + row;
        if (gx < N) {
          const T tgt = F.relax != nullptr ? __ldcs(F.relax + k) - cc : -cc;
          F.dtr[EXT ? ((size_t)l * nptr + j) * ON + orow : k] =
              mjac(pn, cn, i12d2) + p.iPe[j] * lap + p.ir[j] * tgt;
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
}

// PER: the periodic kernel, whose edge strips wrap (hazard 6).
template <typename T, int NPT, bool PER>
__global__ void __launch_bounds__(NTH)
tracer_kernel(const Fields<T> F, const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);      // (R, 1 + nptr, PW)
  const int N = p.N, l = blockIdx.z;
  const int row0 = EXT ? p.row0 : 0, ny = EXT ? p.ny : N;
  const int x0 = blockIdx.x * TX, y0 = row0 + blockIdx.y * p.rows;
  const int y1 = min(y0 + p.rows, row0 + ny);      // output rows [y0, y1)
  // a strip that reads a ghost row or holds column 0 or N - 1 (hazard 5)
  const bool edge = x0 == 0 || x0 + TX >= N || y0 == 0 || y1 == N;
  if (PER && edge)
    march<T, NPT, false, true>(F, p, ring, x0, y0, y1, l);
  else if (edge)
    march<T, NPT, !PER>(F, p, ring, x0, y0, y1, l);
  else
    march<T, NPT, false>(F, p, ring, x0, y0, y1, l);
}

template <typename T>
int run(void (*kernel)(const Fields<T>, const Params<T>), const Fields<T>& F,
        const Params<T>& p, dim3 grid, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(NTH);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(F, p);
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<size_t>(ptr) & 15) == 0;
}

template <typename T>
int launch(const void* psi, const void* tr, const void* relax, void* dtr,
           int N, int nl, int nptr, double delta, const double* iPe,
           const double* ir, int rows, int grid_x, int grid_y,
           long long smem, int periodic, int row0, int ny, int ext,
           void* stream) {
  // the caller's geometry must cover the planes' ny output rows with whole
  // strips of TX columns and `rows` rows, the last keeping the remainder,
  // and give the ring its shared memory
  if (nl < 1 || nl > 65535 || nptr < 1 || nptr > MAXTR || N < 1
      || (periodic && N < 4) || ny < 1 || row0 < 0 || row0 + ny > N
      || (ext != 0) != EXT || (!ext && (row0 != 0 || ny != N))
      || !psi || !tr || !dtr || rows < 1
      || grid_x != (N + TX - 1) / TX || grid_y != (ny + rows - 1) / rows
      || smem < (long long)(sizeof(T) * smem_cells(nptr)))
    return (int)cudaErrorInvalidValue;
  Fields<T> F;
  F.psi = static_cast<const T*>(psi);
  F.tr = static_cast<const T*>(tr);
  F.relax = static_cast<const T*>(relax);
  F.dtr = static_cast<T*>(dtr);
  Params<T> p;
  p.N = N;
  p.nptr = nptr;
  p.rows = rows;
  p.row0 = row0;
  p.ny = ny;
  // 16-byte copies need every input row to start on 16 bytes
  p.vec = N % (16 / (int)sizeof(T)) == 0 && aligned16(psi) && aligned16(tr);
  p.id2 = T(1.0 / (delta * delta));
  p.i12d2 = T(1.0 / (12.0 * delta * delta));
  for (int j = 0; j < MAXTR; ++j) {
    p.iPe[j] = T(j < nptr ? iPe[j] : 0.0);
    p.ir[j] = T(j < nptr ? ir[j] : 0.0);
  }
  const dim3 grid(grid_x, grid_y, nl);
  if (periodic)
    return nptr == 2
               ? run(tracer_kernel<T, 2, true>, F, p, grid, smem, stream)
               : run(tracer_kernel<T, 0, true>, F, p, grid, smem, stream);
  return nptr == 2
             ? run(tracer_kernel<T, 2, false>, F, p, grid, smem, stream)
             : run(tracer_kernel<T, 0, false>, F, p, grid, smem, stream);
}

}  // namespace

extern "C" {

// Most tracers per layer the kernel takes.
int fused_tracer_max_nptr() { return MAXTR; }

// psi (nl, N, N), tr and dtr (nl * nptr, N, N), relax the same or null;
// iPe and ir host arrays of nptr doubles; device pointers on `stream`;
// strips of `rows` rows on a grid_x x grid_y x nl grid with `smem` bytes
// of shared memory a block; periodic != 0 wraps every field (N >= 4).
// ext != 0 is the rows mode (the library of fused_tracer_rows.cu takes it,
// this one refuses it): the output rows [row0, row0 + ny), psi and tr
// the shard's halo-extended (.., ny + 16, N) slabs, dtr (nl * nptr, ny, N),
// relax whole (without it row0 = 0 and ny = N). Returns the CUDA error
// code of the launch (0 on success).
int fused_tracer_f32(const void* psi, const void* tr, const void* relax,
                     void* dtr, int N, int nl, int nptr, double delta,
                     const double* iPe, const double* ir, int rows,
                     int grid_x, int grid_y, long long smem, int periodic,
                     int row0, int ny, int ext, void* stream) {
  return launch<float>(psi, tr, relax, dtr, N, nl, nptr, delta, iPe, ir,
                       rows, grid_x, grid_y, smem, periodic, row0, ny, ext,
                       stream);
}

int fused_tracer_f64(const void* psi, const void* tr, const void* relax,
                     void* dtr, int N, int nl, int nptr, double delta,
                     const double* iPe, const double* ir, int rows,
                     int grid_x, int grid_y, long long smem, int periodic,
                     int row0, int ny, int ext, void* stream) {
  return launch<double>(psi, tr, relax, dtr, N, nl, nptr, delta, iPe, ir,
                        rows, grid_x, grid_y, smem, periodic, row0, ny, ext,
                        stream);
}

const char* fused_tracer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
