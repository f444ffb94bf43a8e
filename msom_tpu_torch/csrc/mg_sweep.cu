// Red-black vertical-line relaxation for Hopper (sm_90a): kernel K3 of the
// port.
//
// Replaces the Pallas TPU kernel `_sweep_kernel`
// (msom_tpu/solvers/pallas_mg.py, entry `rb_line_sweep`) on levels whose
// coefficients are y-profiles. One launch is k full sweeps of the layered
// multigrid's smoother (solvers/mg.py `_relax_layered`): for the red cells
// ((row + column) even), then for the black cells on the result of the red
// pass, per cell
//
//   rhs[l] = -d2 * res[l] + (((E + W) + N) + S of da[l])
//   dp[0]  = rhs[0] * im[0];  dp[l] = (rhs[l] - t0[l] * dp[l-1]) * im[l]
//   x[nl-1] = dp[nl-1];       x[l]  = dp[l] - cp[l] * x[l+1]
//
// the exact solve of the column's vertical tridiagonal system with the
// horizontal neighbours frozen (poisson_layer.h:48-150). t0, cp, im are the
// (nl, n) y-profiles of the Thomas factors. A neighbour beyond a wall is the
// ghost sign * (current value of the edge cell itself), Dirichlet -1 /
// Neumann +1, evaluated when the cell is relaxed, hence anew for each
// colour. With PX (the TPU kernel's `periodic_x`, a kernel of its own) x
// wraps and the neighbour above row 0 is the input's row 7, the one below
// row n - 1 the input's row n - 8, both as they were before the sweep: the
// rows the TPU kernel's clamped 8-row halo blocks give it (pallas_mg.py
// `_halo_specs`), never relaxed. A PX launch runs one sweep.
//
// Every cell's update reads the same operands in the same order whatever k
// is, and the contractions are spelled out (fma_), so a launch of k sweeps
// equals k one-sweep launches bit for bit. Without the fma (as
// tools/k3_emulation.py compiles it on the host) it is the plain version's
// arithmetic, term for term.
//
// Two forms.
//
// The strip (levels that do not fit one block). A block owns W columns and
// `rows` rows of all nl layers and marches down y. A ring of RING rows of
// da and of res (all layers, the W columns and XH = 2 KMAX more on each
// side) sits in shared memory, fed by cp.async, 16-byte chunks where n and
// the pointers allow, else one element a copy, issued DEPTH steps before
// the row's first use (RING as many rows as 96 KB holds, at least
// LAG (KMAX - 1) + 6 and at most 32: 21 rows and DEPTH 8 at nl = 4 in f32,
// two blocks an SM); t0, cp and im of the strip's rows sit beside it.
// The k sweeps form a wavefront: in step g sweep s relaxes red on row
// g - LAG s + 1, then black on row g - LAG s. Thread (s, j) of the block runs
// sweep s on the column pair j, and red on row t + 1 and black on row t are
// the same column, 2j + ((t + 1) & 1) of the ring row: the black cell's
// neighbour above is the red cell the same thread has just relaxed, its
// other red neighbours were relaxed in earlier steps. With LAG = 3 sweep s's
// red on row t + 1 reads sweep s - 1's black on row t + 2, also done in the
// step before, and no sweep writes a row that another sweep reads in the
// same step; so a step needs ONE barrier, at its end, whatever k is (with
// LAG = 2 sweep s would read a row sweep s - 1 writes in the same step). A
// row is stored one step after sweep k - 1's black has finished it. Blocks
// run in no order, so the halo is relaxed redundantly by K6's
// shrinking-ring rule (vmg_sweep.cu), in x and in y: sweep s (1-based)
// relaxes red within 2k - 2s + 1 cells of the block's tile, black within
// 2k - 2s, and the tile is exact after k sweeps; the march starts 2k rows
// above the tile and loads 2k rows below it.
//
// Where it could go wrong, and what the march does about it:
//  1. Slots. In step g the ring holds rows g - LAG (k - 1) - 1 (read by
//     sweep k - 1's black, and stored) to g + 2 (read by sweep 0's red),
//     and rows g + 3 .. g + 2 + DEPTH are landing, the last issued in step
//     g into the slot of a row no step after g - 1 reads: DEPTH = RING -
//     (LAG (KMAX - 1) + 4) (tools/k3_emulation.py runs DEPTH one deeper,
//     the ring one row short, and shows it wrong).
//  2. Within a step a thread reads what other threads write only in
//     earlier steps: sweep s writes rows g - LAG s + 1 (red) and g - LAG s
//     (black) and reads the rows next to them, LAG = 3 rows from the next
//     sweep's, and a black cell's one neighbour relaxed in the same step is
//     its own thread's (tools/k3_emulation.py runs LAG = 2, a red reach one
//     short, a wait one short and a store one step early, and each goes
//     wrong).
//  3. Cells outside the level are never fetched, relaxed or stored; a halo
//     cell is relaxed only where its neighbours are current.
//  4. PX: the halo columns come modulo n (n even keeps the colours), and
//     rows -1 and n of the ring are the input's rows 7 and n - 8.
//
// The whole level (n <= WHOLE_N, where da, res and the profiles fit in a
// block's shared memory: n <= 64 at nl <= 4 in f32): one block stages the
// level, runs all k sweeps with a barrier after each colour, and stores
// it, so a level's relaxation is one launch whatever nrelax is.
//
// Bound. Bytes: da and res read, da written, 3 * nl * n^2 values, once a
// launch: at 2048^2 x 4 in f32 201 MB, 0.060 ms at 3.35 TB/s. About 10
// operations per cell, layer and sweep, 2.5 us a sweep at 67 TFLOP/s:
// bytes bound it. The strip reads its halo as well: (W + 2 XH) / W times
// (rows + 4 k) / rows the planes of da and res.

#include <cuda_runtime.h>

namespace {

constexpr int MAXNL = 8;
constexpr int KMAX = 4;            // sweeps a strip launch takes at most
constexpr int LAG = 3;             // rows sweep s + 1 trails sweep s
constexpr int XH = 2 * KMAX;       // ring columns each side of the tile
constexpr int RING_BYTES = 96 * 1024;   // the ring's shared memory
constexpr int RING_MAX = 32;       // ring rows at most
static_assert(XH % 4 == 0, "16-byte chunks start on the tile's grid");
constexpr int WHOLE_N = 64;        // widest level the whole form takes
constexpr int WHOLE_NTH = 512;     // threads of the whole form
constexpr int SMEM_MAX = 227 * 1024;
constexpr int WAVE_SMS = 132;      // SMs of an H100 SXM

template <typename T>
struct Args {
  const T* da;
  const T* res;
  const T* t0;
  const T* cp;
  const T* im;
  T* out;
  int n, nsweep, rows;
  bool vec;               // 16-byte copies: n % V == 0, aligned pointers
  T md2, sign_x, sign_y;  // md2 = -d2
};

// The strip's geometry for a type and nl: W columns, so that a ring row of
// all layers stays near 2.3 KB (W = 128 where nl * sizeof(T) <= 16); as
// many ring rows as RING_BYTES holds (two blocks an SM), and the rows a
// step does not read are in flight: DEPTH steps ahead (hazard 1).
template <typename T, int NL>
struct Geo {
  static constexpr int COL = NL * (int)sizeof(T);
  static constexpr int W = COL <= 16 ? 128 : (COL <= 32 ? 64 : 32);
  static constexpr int RW = W + 2 * XH;        // ring row of one layer
  static constexpr int ROW = NL * RW;          // ring row of all layers
  static constexpr int PAIRS = RW / 2;
  static constexpr int NTH = KMAX * PAIRS;     // thread (sweep, pair)
  static constexpr int V = 16 / (int)sizeof(T);
  static constexpr int FIT = RING_BYTES / (2 * ROW * (int)sizeof(T));
  static constexpr int RMIN = LAG * (KMAX - 1) + 6;   // DEPTH 2 at least
  static constexpr int RING =
      FIT < RMIN ? RMIN : (FIT < RING_MAX ? FIT : RING_MAX);
  static constexpr int DEPTH = RING - (LAG * (KMAX - 1) + 4);
  static_assert(DEPTH >= 2, "the ring (hazard 1)");
};

// The ring slot of row r >= -1 (-1: the PX ghost row above row 0).
template <int RING>
__device__ __forceinline__ int slot(int r) { return (r + RING) % RING; }

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

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

// Relax the column of one cell in place: c its layer-0 value, cn and cs the
// same cell of the rows above (r + 1) and below (r - 1), ls the layer
// stride of all three, rs its res (layer stride rls), t0/cp/im its row's
// profiles (layer stride ps); the w flags mark a wall beyond the cell.
template <typename T, int NL>
__device__ __forceinline__ void relax_column(
    T* c, const T* cn, const T* cs, int ls, const T* rs, int rls,
    const T* t0, const T* cp, const T* im, int ps, bool wx0, bool wx1,
    bool wy0, bool wy1, const Args<T>& p) {
  T dp[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const T self = c[l * ls];
    const T e = wx1 ? p.sign_x * self : c[l * ls + 1];
    const T w = wx0 ? p.sign_x * self : c[l * ls - 1];
    const T no = wy1 ? p.sign_y * self : cn[l * ls];
    const T so = wy0 ? p.sign_y * self : cs[l * ls];
    const T rhs = fma_(p.md2, rs[l * rls], ((e + w) + no) + so);
    const T iml = im[l * ps];
    if (l == 0)
      dp[0] = rhs * iml;
    else
      dp[l] = fma_(-t0[l * ps], dp[l - 1], rhs) * iml;
  }
  T x = dp[NL - 1];
  c[(NL - 1) * ls] = x;
#pragma unroll
  for (int l = NL - 2; l >= 0; --l) {
    x = fma_(-cp[l * ps], x, dp[l]);
    c[l * ls] = x;
  }
}

// ---------------------------------------------------------------------------
// the strip
// ---------------------------------------------------------------------------

// Issue the copies of ring row r (da and res, all layers) when it lies in
// the rows the block loads, [ybeg, yend).
template <typename T, int NL, bool PX>
__device__ __forceinline__ void issue_row(const Args<T>& p, T* ring, int r,
                                          int ybeg, int yend, int x0) {
  using G = Geo<T, NL>;
  if (r < ybeg || r >= yend) return;
  const int n = p.n;
  const int sr = PX ? (r < 0 ? 7 : (r >= n ? n - 8 : r)) : r;
  const size_t nn = (size_t)n * n;
  T* dst = ring + slot<G::RING>(r) * G::ROW;
  const size_t row = (size_t)sr * n;
  if (p.vec) {
    constexpr int CH = G::RW / G::V;             // chunks of a layer row
    for (int i = threadIdx.x; i < 2 * NL * CH; i += G::NTH) {
      const int f = i / (NL * CH), l = (i / CH) % NL, cj = i % CH;
      int gc = x0 - XH + cj * G::V;
      if (PX)
        gc = ((gc % n) + n) % n;
      else if (gc < 0 || gc >= n)
        continue;
      cp_async<16>(dst + f * G::RING * G::ROW + l * G::RW + cj * G::V,
                   (f ? p.res : p.da) + row + l * nn + gc);
    }
  } else {
    for (int i = threadIdx.x; i < 2 * NL * G::RW; i += G::NTH) {
      const int f = i / (NL * G::RW), l = (i / G::RW) % NL, cl = i % G::RW;
      int gc = x0 - XH + cl;
      if (PX)
        gc = ((gc % n) + n) % n;
      else if (gc < 0 || gc >= n)
        continue;
      cp_async<(int)sizeof(T)>(
          dst + f * G::RING * G::ROW + l * G::RW + cl,
          (f ? p.res : p.da) + row + l * nn + gc);
    }
  }
}

// Store ring row r's tile columns [x0, xe) of all layers to the output.
template <typename T, int NL>
__device__ __forceinline__ void store_row(const Args<T>& p, const T* ring,
                                          int r, int x0, int xe) {
  using G = Geo<T, NL>;
  const size_t nn = (size_t)p.n * p.n;
  const T* src = ring + slot<G::RING>(r) * G::ROW + XH;
  T* dst = p.out + (size_t)r * p.n + x0;
  const int w = xe - x0;
  if (p.vec) {
    const int ch = w / G::V;
    for (int i = threadIdx.x; i < NL * ch; i += G::NTH) {
      const int l = i / ch, cj = i % ch;
      *reinterpret_cast<uint4*>(dst + l * nn + cj * G::V) =
          *reinterpret_cast<const uint4*>(src + l * G::RW + cj * G::V);
    }
  } else {
    for (int i = threadIdx.x; i < NL * w; i += G::NTH) {
      const int l = i / w, c = i % w;
      dst[l * nn + c] = src[l * G::RW + c];
    }
  }
}

template <typename T, int NL, bool PX>
__global__ void __launch_bounds__((Geo<T, NL>::NTH)) mg_strip_kernel(
    const Args<T> p) {
  using G = Geo<T, NL>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);    // da, then res: RING rows
  T* rres = ring + G::RING * G::ROW;
  T* prof = rres + G::RING * G::ROW;           // t0, cp, im: [3][NL][rows]
  const int n = p.n, k = p.nsweep;
  const int x0 = blockIdx.x * G::W, y0 = blockIdx.y * p.rows;
  const int xe = min(x0 + G::W, n), ye = min(y0 + p.rows, n);
  // the rows the block loads (PX: rows -1 and n are the ghost rows)
  const int ybeg = max(PX ? -1 : 0, y0 - 2 * k);
  const int yend = min(PX ? n + 1 : n, ye + 2 * k);
  const int prow = yend - ybeg;                // profile rows held
  for (int i = threadIdx.x; i < 3 * NL * prow; i += G::NTH) {
    const int f = i / (NL * prow), l = (i / prow) % NL, r = ybeg + i % prow;
    const T* src = f == 0 ? p.t0 : (f == 1 ? p.cp : p.im);
    if (r >= 0 && r < n) prof[i] = src[l * n + r];
  }
  // the first rows: each row its own copy group
#pragma unroll 1
  for (int i = 0; i <= G::DEPTH; ++i) {
    issue_row<T, NL, PX>(p, ring, ybeg + i, ybeg, yend, x0);
    cp_async_commit();
  }
  cp_async_wait<G::DEPTH - 1>();
  __syncthreads();

  const int s = threadIdx.x / G::PAIRS, j = threadIdx.x % G::PAIRS;
  // sweep s's reach beyond the tile: red rr, black rr - 1 (1-based s + 1)
  const int rr = 2 * k - 2 * s - 1;
  const int g0 = ybeg - 1, gend = ye + LAG * (k - 1);
#pragma unroll 1
  for (int g = g0; g <= gend; ++g) {
    issue_row<T, NL, PX>(p, ring, g + 2 + G::DEPTH, ybeg, yend, x0);
    cp_async_commit();
#pragma unroll
    for (int color = 0; color < 2; ++color) {
      const int reach = rr - color;
      const int r = g - LAG * s + 1 - color;   // red on t + 1, black on t
      if (s < k && r >= max(0, y0 - reach) && r < min(n, ye + reach)) {
        const int lc = 2 * j + ((r + color) & 1);
        const int gx = x0 - XH + lc;             // unwrapped under PX
        const bool in = PX ? (gx >= x0 - reach && gx < xe + reach)
                           : (gx >= max(0, x0 - reach)
                              && gx < min(n, xe + reach));
        if (in) {
          T* c = ring + slot<G::RING>(r) * G::ROW + lc;
          const T* cn = ring + slot<G::RING>(r + 1) * G::ROW + lc;
          const T* cs = ring + slot<G::RING>(r - 1) * G::ROW + lc;
          const T* rs = rres + slot<G::RING>(r) * G::ROW + lc;
          const T* pr = prof + (r - ybeg);
          relax_column<T, NL>(c, cn, cs, G::RW, rs, G::RW, pr,
                              pr + NL * prow, pr + 2 * NL * prow, prow,
                              !PX && gx == 0, !PX && gx == n - 1,
                              !PX && r == 0, !PX && r == n - 1, p);
        }
      }
    }
    // the row sweep k - 1's black finished in the step before
    const int rs = g - LAG * (k - 1) - 1;
    if (rs >= y0 && rs < ye) store_row<T, NL>(p, ring, rs, x0, xe);
    cp_async_wait<G::DEPTH - 1>();
    __syncthreads();
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// the whole level
// ---------------------------------------------------------------------------

template <typename T, int NL>
__global__ void __launch_bounds__(WHOLE_NTH) mg_whole_kernel(const Args<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = p.n, nn = n * n;
  T* sda = reinterpret_cast<T*>(smem_raw);     // [NL][n][n]
  T* sres = sda + NL * nn;
  T* prof = sres + NL * nn;                    // t0, cp, im: [3][NL][n]
  for (int i = threadIdx.x; i < NL * nn; i += WHOLE_NTH) {
    sda[i] = p.da[i];
    sres[i] = p.res[i];
  }
  for (int i = threadIdx.x; i < 3 * NL * n; i += WHOLE_NTH) {
    const int f = i / (NL * n);
    const T* src = f == 0 ? p.t0 : (f == 1 ? p.cp : p.im);
    prof[i] = src[i % (NL * n)];
  }
  __syncthreads();
  const int hc = (n + 1) / 2;                  // cells of a colour a row
#pragma unroll 1
  for (int sweep = 0; sweep < p.nsweep; ++sweep) {
#pragma unroll 1
    for (int color = 0; color < 2; ++color) {
      for (int i = threadIdx.x; i < n * hc; i += WHOLE_NTH) {
        const int r = i / hc;
        const int x = 2 * (i % hc) + ((r + color) & 1);
        if (x >= n) continue;
        T* c = sda + r * n + x;
        relax_column<T, NL>(c, c + n, c - n, nn, sres + r * n + x, nn,
                            prof + r, prof + NL * n + r,
                            prof + 2 * NL * n + r, n, x == 0, x == n - 1,
                            r == 0, r == n - 1, p);
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < NL * nn; i += WHOLE_NTH) p.out[i] = sda[i];
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int NL>
constexpr size_t whole_smem(int n) {
  return sizeof(T) * NL * ((size_t)2 * n * n + 3 * n);
}

template <typename T, int NL>
bool whole_fits(int n) {
  return n <= WHOLE_N && whole_smem<T, NL>(n) <= (size_t)SMEM_MAX;
}

template <typename T, int NL>
size_t strip_smem(int rows) {
  using G = Geo<T, NL>;
  return sizeof(T) * ((size_t)2 * G::RING * G::ROW
                      + (size_t)3 * NL * (rows + 4 * KMAX + 2));
}

// Strip rows: the tallest of 256 .. 16 whose grid still fills a wave of
// resident blocks (a fuller wave wins nothing more; taller strips load
// fewer halo rows).
template <typename T, int NL>
int strip_rows(int n, int resident) {
  using G = Geo<T, NL>;
  const int nbx = (n + G::W - 1) / G::W;
  for (int rows = 256; rows > 16; rows /= 2)
    if (10 * nbx * ((n + rows - 1) / rows) >= 9 * resident) return rows;
  return 16;
}

template <typename T, int NL, bool PX>
int launch_strip(Args<T> p, cudaStream_t stream) {
  using G = Geo<T, NL>;
  auto kernel = mg_strip_kernel<T, NL, PX>;
  static int per_sm = 0;    // resident blocks an SM, asked once
  if (per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)strip_smem<T, NL>(256));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, G::NTH, strip_smem<T, NL>(64));
    if (err != cudaSuccess) {
      per_sm = 0;
      return (int)err;
    }
    if (per_sm < 1) per_sm = 1;
  }
  p.rows = strip_rows<T, NL>(p.n, WAVE_SMS * per_sm);
  const dim3 grid((p.n + G::W - 1) / G::W, (p.n + p.rows - 1) / p.rows);
  kernel<<<grid, G::NTH, strip_smem<T, NL>(p.rows), stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int NL>
int launch_whole(const Args<T>& p, cudaStream_t stream) {
  const size_t smem = whole_smem<T, NL>(p.n);
  if (smem > 48 * 1024) {   // more than a block gets without asking
    const cudaError_t err = cudaFuncSetAttribute(
        mg_whole_kernel<T, NL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mg_whole_kernel<T, NL><<<1, WHOLE_NTH, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The most sweeps one launch takes at (n, nl) in T: every count for the
// whole form, KMAX for the strip, 1 under PX (0 for what no form takes).
template <typename T, int NL>
int per_launch(int n, bool px) {
  if (px) return n >= 8 && n % 2 == 0 ? 1 : 0;
  return whole_fits<T, NL>(n) ? 1 << 30 : KMAX;
}

template <typename T, int NL>
int launch_nl(const Args<T>& p, bool px, cudaStream_t s) {
  const int most = per_launch<T, NL>(p.n, px);
  if (p.nsweep < 1 || p.nsweep > most) return (int)cudaErrorInvalidValue;
  if (px) return launch_strip<T, NL, true>(p, s);
  return whole_fits<T, NL>(p.n) ? launch_whole<T, NL>(p, s)
                                : launch_strip<T, NL, false>(p, s);
}

template <typename T>
int per_launch_nl(int n, int nl, bool px) {
  switch (nl) {
    case 1: return per_launch<T, 1>(n, px);
    case 2: return per_launch<T, 2>(n, px);
    case 3: return per_launch<T, 3>(n, px);
    case 4: return per_launch<T, 4>(n, px);
    case 5: return per_launch<T, 5>(n, px);
    case 6: return per_launch<T, 6>(n, px);
    case 7: return per_launch<T, 7>(n, px);
    case 8: return per_launch<T, 8>(n, px);
    default: return 0;
  }
}

template <typename T>
int launch(const void* da, const void* res, const void* t0, const void* cp,
           const void* im, void* out, int n, int nl, double d2, double sign_x,
           double sign_y, int nsweep, int periodic_x, void* stream) {
  if (n < 1 || n > 16 * 65535 || !da || !res || !t0 || !cp || !im || !out
      || da == out)
    return (int)cudaErrorInvalidValue;
  Args<T> p;
  p.da = static_cast<const T*>(da);
  p.res = static_cast<const T*>(res);
  p.t0 = static_cast<const T*>(t0);
  p.cp = static_cast<const T*>(cp);
  p.im = static_cast<const T*>(im);
  p.out = static_cast<T*>(out);
  p.n = n;
  p.nsweep = nsweep;
  p.rows = 0;
  const size_t V = 16 / sizeof(T);
  p.vec = n % V == 0
          && ((reinterpret_cast<size_t>(da) | reinterpret_cast<size_t>(res)
               | reinterpret_cast<size_t>(out)) % 16) == 0;
  p.md2 = T(-d2);
  p.sign_x = T(sign_x);
  p.sign_y = T(sign_y);
  const bool px = periodic_x != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nl) {
    case 1: return launch_nl<T, 1>(p, px, s);
    case 2: return launch_nl<T, 2>(p, px, s);
    case 3: return launch_nl<T, 3>(p, px, s);
    case 4: return launch_nl<T, 4>(p, px, s);
    case 5: return launch_nl<T, 5>(p, px, s);
    case 6: return launch_nl<T, 6>(p, px, s);
    case 7: return launch_nl<T, 7>(p, px, s);
    case 8: return launch_nl<T, 8>(p, px, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Most layers the kernel takes.
int mg_sweep_max_nl() { return MAXNL; }

// The most sweeps one launch at (n, nl) of an itemsize (4 or 8) takes:
// 2^30 where the level runs whole, the strip's KMAX, 1 with periodic_x;
// 0 where no launch is taken (periodic_x needs an even n >= 8).
int mg_sweep_per_launch(int n, int nl, int itemsize, int periodic_x) {
  return itemsize == 4 ? per_launch_nl<float>(n, nl, periodic_x != 0)
                       : per_launch_nl<double>(n, nl, periodic_x != 0);
}

// nsweep red-black sweeps of da against res into out in one launch: da,
// res and out (nl, n, n), out another array than da; t0, cp, im (nl, n);
// device pointers on `stream`. Returns the CUDA error code of the launch (0
// on success).
int mg_sweep_f32(const void* da, const void* res, const void* t0,
                 const void* cp, const void* im, void* out, int n, int nl,
                 double d2, double sign_x, double sign_y, int nsweep,
                 int periodic_x, void* stream) {
  return launch<float>(da, res, t0, cp, im, out, n, nl, d2, sign_x, sign_y,
                       nsweep, periodic_x, stream);
}

int mg_sweep_f64(const void* da, const void* res, const void* t0,
                 const void* cp, const void* im, void* out, int n, int nl,
                 double d2, double sign_x, double sign_y, int nsweep,
                 int periodic_x, void* stream) {
  return launch<double>(da, res, t0, cp, im, out, n, nl, d2, sign_x, sign_y,
                        nsweep, periodic_x, stream);
}

const char* mg_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
