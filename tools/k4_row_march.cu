// K4 as a row march: a design variant of msom_tpu_torch/csrc/mg_residual.cu
// that tools/k3_variants.py builds and times beside the shipped tile (the
// same C entries); the port does not build or run it.
//
// Replaces the Pallas TPU kernel `_mg_residual_kernel`
// (msom_tpu/solvers/pallas_mg.py, entry `residual_norm`) on levels whose
// coefficients are y-profiles. In one launch
//
//   res[l] = b[l] - lap(a[l]) - Gamma(a)[l] - lam[l] * a[l]
//   Gamma(a)[l] = up[l-1] * idh0[l] - up[l] * idh1[l],
//   up[l] = s[l] * (a[l] - a[l+1])
//
// (poisson_layer.h:157-258) and max|res|, a 0-d result. s (nl-1, n) and
// lam (nl, n) are y-profiles, each optional (a null pointer); the wall ghost
// of a is sign * edge cell, Dirichlet -1 / Neumann +1. With PX (the TPU
// kernel's `periodic_x`, a kernel of its own) x wraps and the ghost above
// row 0 is row 7, the one below row n - 1 row n - 8, the rows the TPU
// kernel's clamped 8-row halo blocks give it (pallas_mg.py `_halo_specs`).
//
// Design: K1's row march (csrc/fused_rhs.cu) for a 5-point stencil. A block
// of NTH threads owns W columns and ROWS rows of all nl layers and marches
// down y. A ring of RING rows of a (all layers, the W columns and one
// 16-byte chunk more on each side) and of b sits in shared memory, fed by
// cp.async, 16-byte chunks where n and the pointers allow, else one element
// a copy: step r issues rows r + 1 + DEPTH of a and b, computes output row
// r from rows r - 1 .. r + 1 of a and row r of b, and waits for row r + 2,
// so a step has one barrier and DEPTH rows of both inputs are in flight.
// Thread item (l, j) computes V = 16 / sizeof(T) columns of layer l and
// stores them, 16 bytes a thread where aligned; it reads its chunk of each
// row (and of the layers above and below, for the vertical coupling) from
// the ring with 16-byte accesses, and the row's profiles once. W is 128 chunks of V a layer
// row for nl = 1, 64 for nl = 2, 32 above, so that a row gives every
// thread work.
//
// The max norm in the same launch: each block reduces its cells' maximum
// (through shared memory) into its slot of `partial`; then its thread 0
// makes the slot visible (__threadfence) and takes a ticket (atomicAdd).
// The block that draws the last ticket reduces all slots, in slot order,
// into the 0-d result and sets the ticket back to 0 for the next launch.
// The reduction carries a NaN once it has seen one, as the plain version's
// max does; max is exact, so the result does not depend on the blocks'
// order.
//
// Bound. Bytes: a and b read, res written, 3 * nl * n^2 values; at
// 2048^2 x 4 in f32 201 MB, 0.060 ms at 3.35 TB/s. About 15 operations per
// cell and layer, 3.8 us at 67 TFLOP/s: bytes bound it. The march reads a
// (ROWS + 2) / ROWS times (W + 2 V) / W times, b once.

#include <cuda_runtime.h>

namespace {

constexpr int MAXNL = 8;
constexpr int NTH = 128;           // threads a block
constexpr int ROWS = 16;           // output rows of a strip
constexpr int DEPTH = 4;           // row r + 1 + DEPTH is issued in step r
constexpr int RING = 8;            // ring rows: r - 1 .. r + 1 + DEPTH
static_assert(RING >= DEPTH + 3, "the ring");
static_assert((RING & (RING - 1)) == 0, "the slot is a mask");

template <typename T>
struct Args {
  const T* a;
  const T* b;
  const T* s;     // (nl-1, n) or null
  const T* lam;   // (nl, n) or null
  T* res;
  T* partial;     // one maximum per block
  unsigned* ticket;
  T* mx;          // the 0-d maximum
  int n;
  bool vec;       // 16-byte copies: n % V == 0, aligned pointers
  T idelta2, sign_x, sign_y;
  T idh0[MAXNL], idh1[MAXNL];
};

template <typename T, int NL>
struct Geo {
  static constexpr int V = 16 / (int)sizeof(T);
  static constexpr int CH = NL == 1 ? 128 : (NL == 2 ? 64 : 32);
  static constexpr int W = CH * V;             // columns of a strip
  static constexpr int RW = W + 2 * V;         // ring row of one layer
  static constexpr int ROW = NL * RW;          // ring row of a, all layers
  static constexpr int BROW = NL * W;          // ring row of b, all layers
};

// max that keeps a NaN: m stays NaN once it is, and takes a NaN v
template <typename T>
__device__ __forceinline__ T nanmax(T m, T v) {
  return (v > m || v != v) ? v : m;
}

__device__ __forceinline__ int slot(int r) { return r & (RING - 1); }

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

// Issue the copies of ring row r: a's when r lies in [lo, hi), b's (the
// W columns) when r lies in [y0, ye).
template <typename T, int NL, bool PX>
__device__ __forceinline__ void issue_row(const Args<T>& p, T* ring, T* rb,
                                          int r, int lo, int hi, int y0,
                                          int ye, int x0) {
  using G = Geo<T, NL>;
  const int n = p.n;
  const size_t nn = (size_t)n * n;
  if (r >= lo && r < hi) {
    const int sr = PX ? (r < 0 ? 7 : (r >= n ? n - 8 : r)) : r;
    T* dst = ring + slot(r) * G::ROW;
    const T* src = p.a + (size_t)sr * n;
    if (p.vec) {
      constexpr int CR = G::RW / G::V;           // chunks of a layer row
      for (int i = threadIdx.x; i < NL * CR; i += NTH) {
        const int l = i / CR, cj = i % CR;
        int gc = x0 - G::V + cj * G::V;
        if (PX)
          gc = ((gc % n) + n) % n;
        else if (gc < 0 || gc >= n)
          continue;
        cp_async<16>(dst + l * G::RW + cj * G::V, src + l * nn + gc);
      }
    } else {
      for (int i = threadIdx.x; i < NL * G::RW; i += NTH) {
        const int l = i / G::RW, cl = i % G::RW;
        int gc = x0 - G::V + cl;
        if (PX)
          gc = ((gc % n) + n) % n;
        else if (gc < 0 || gc >= n)
          continue;
        cp_async<(int)sizeof(T)>(dst + l * G::RW + cl, src + l * nn + gc);
      }
    }
  }
  if (r >= y0 && r < ye) {
    T* dst = rb + slot(r) * G::BROW;
    const T* src = p.b + (size_t)r * n + x0;
    const int w = min(G::W, n - x0);
    if (p.vec) {
      const int ch = w / G::V;
      for (int i = threadIdx.x; i < NL * ch; i += NTH) {
        const int l = i / ch, cj = i % ch;
        cp_async<16>(dst + l * G::W + cj * G::V, src + l * nn + cj * G::V);
      }
    } else {
      for (int i = threadIdx.x; i < NL * w; i += NTH) {
        const int l = i / w, c = i % w;
        cp_async<(int)sizeof(T)>(dst + l * G::W + c, src + l * nn + c);
      }
    }
  }
}

// V values of T, one 16-byte shared-memory access.
template <typename T>
union Pack {
  uint4 u;
  T v[16 / sizeof(T)];
};

template <typename T>
__device__ __forceinline__ Pack<T> ld16(const T* p) {
  Pack<T> x;
  x.u = *reinterpret_cast<const uint4*>(p);
  return x;
}

// res of the V cells of layer l, row r, from global column gx0 (ring column
// lc0 of the rows' slots cur, up (r + 1), dn (r - 1); b's row brow): the
// chunk's rows read with 16-byte accesses, the row's profiles once.
template <typename T, int NL, bool PX>
__device__ __forceinline__ Pack<T> chunk_res(const Args<T>& p, const T* cur,
                                             const T* up, const T* dn,
                                             const T* bp, int l, int lc0,
                                             int r, int gx0) {
  using G = Geo<T, NL>;
  constexpr int V = G::V;
  const int n = p.n;
  const T* cl = cur + l * G::RW + lc0;
  const Pack<T> c = ld16(cl), u = ld16(up + l * G::RW + lc0),
                d = ld16(dn + l * G::RW + lc0), b = ld16(bp);
  const T left = cl[-1], right = cl[V];
  const bool coupled = NL > 1 && p.s != nullptr;
  Pack<T> am = c, ap = c;                      // the layers above, below
  T s0 = T(0), s1 = T(0);
  if (coupled && l > 0) {
    am = ld16(cl - G::RW);
    s0 = p.s[(l - 1) * n + r];
  }
  if (coupled && l < NL - 1) {
    ap = ld16(cl + G::RW);
    s1 = p.s[l * n + r];
  }
  const T lam = p.lam != nullptr ? p.lam[l * n + r] : T(0);
  Pack<T> out;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int gx = gx0 + v;
    const T ce = c.v[v];
    const T e = !PX && gx == n - 1 ? p.sign_x * ce
                                   : (v + 1 < V ? c.v[v + 1] : right);
    const T w = !PX && gx == 0 ? p.sign_x * ce : (v > 0 ? c.v[v - 1] : left);
    const T no = !PX && r == n - 1 ? p.sign_y * ce : u.v[v];
    const T so = !PX && r == 0 ? p.sign_y * ce : d.v[v];
    T rs = b.v[v] - ((((e + w) + no) + so) - T(4) * ce) * p.idelta2;
    if (coupled) {
      T g;
      if (l == 0)
        g = -(s1 * (ce - ap.v[v])) * p.idh1[0];
      else if (l == NL - 1)
        g = s0 * (am.v[v] - ce) * p.idh0[l];
      else
        g = s0 * (am.v[v] - ce) * p.idh0[l]
            - s1 * (ce - ap.v[v]) * p.idh1[l];
      rs -= g;
    }
    if (p.lam != nullptr) rs -= lam * ce;
    out.v[v] = rs;
  }
  return out;
}

template <typename T, int NL, bool PX>
__global__ void __launch_bounds__(NTH) mg_residual_kernel(const Args<T> p) {
  using G = Geo<T, NL>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);    // RING rows of a
  T* rb = ring + RING * G::ROW;                // RING rows of b
  T* red = rb + RING * G::BROW;                // NTH block maxima
  int* last = reinterpret_cast<int*>(red + NTH);
  const int n = p.n, tid = threadIdx.x;
  const int x0 = blockIdx.x * G::W, y0 = blockIdx.y * ROWS;
  const int ye = min(y0 + ROWS, n);
  const int lo = max(PX ? -1 : 0, y0 - 1), hi = min(PX ? n + 1 : n, ye + 1);
  const size_t nn = (size_t)n * n;

  // rows y0 - 1 .. y0 + 1, then one group a row up to y0 + DEPTH
  for (int r = y0 - 1; r <= y0 + 1; ++r)
    issue_row<T, NL, PX>(p, ring, rb, r, lo, hi, y0, ye, x0);
  cp_async_commit();
#pragma unroll 1
  for (int r = y0 + 2; r <= y0 + DEPTH; ++r) {
    issue_row<T, NL, PX>(p, ring, rb, r, lo, hi, y0, ye, x0);
    cp_async_commit();
  }
  cp_async_wait<DEPTH - 1>();
  __syncthreads();

  T m = T(0);
#pragma unroll 1
  for (int r = y0; r < ye; ++r) {
    issue_row<T, NL, PX>(p, ring, rb, r + 1 + DEPTH, lo, hi, y0, ye, x0);
    cp_async_commit();
    const T* cur = ring + slot(r) * G::ROW;
    const T* brow = rb + slot(r) * G::BROW;
    const T* up = ring + slot(r + 1) * G::ROW;
    const T* dn = ring + slot(r - 1) * G::ROW;
    for (int i = tid; i < NL * G::CH; i += NTH) {
      const int l = i / G::CH, cj = i % G::CH;
      const int gx0 = x0 + cj * G::V;
      if (gx0 >= n) continue;
      const size_t off = l * nn + (size_t)r * n + gx0;
      const Pack<T> rv = chunk_res<T, NL, PX>(
          p, cur, up, dn, brow + l * G::W + cj * G::V, l, G::V + cj * G::V,
          r, gx0);
      if (p.vec) {
        *reinterpret_cast<uint4*>(p.res + off) = rv.u;
#pragma unroll
        for (int v = 0; v < G::V; ++v)
          m = nanmax(m, rv.v[v] < T(0) ? -rv.v[v] : rv.v[v]);
      } else {
        for (int v = 0; v < G::V && gx0 + v < n; ++v) {
          p.res[off + v] = rv.v[v];
          m = nanmax(m, rv.v[v] < T(0) ? -rv.v[v] : rv.v[v]);
        }
      }
    }
    cp_async_wait<DEPTH - 1>();
    __syncthreads();
  }
  cp_async_wait<0>();

  // the block's maximum, then the last block's maximum over the blocks
  red[tid] = m;
  __syncthreads();
  for (int h = NTH / 2; h > 0; h /= 2) {
    if (tid < h) red[tid] = nanmax(red[tid], red[tid + h]);
    __syncthreads();
  }
  const unsigned nblocks = gridDim.x * gridDim.y;
  if (tid == 0) {
    p.partial[blockIdx.y * gridDim.x + blockIdx.x] = red[0];
    __threadfence();
    *last = atomicAdd(p.ticket, 1u) == nblocks - 1;
  }
  __syncthreads();
  if (!*last) return;
  __threadfence();
  T mb = T(0);
  for (unsigned i = tid; i < nblocks; i += NTH)
    mb = nanmax(mb, *reinterpret_cast<volatile T*>(p.partial + i));
  __syncthreads();
  red[tid] = mb;
  __syncthreads();
  for (int h = NTH / 2; h > 0; h /= 2) {
    if (tid < h) red[tid] = nanmax(red[tid], red[tid + h]);
    __syncthreads();
  }
  if (tid == 0) {
    *p.mx = red[0];
    *p.ticket = 0u;
  }
}

template <typename T, int NL>
constexpr size_t smem_bytes() {
  return sizeof(T) * (RING * (Geo<T, NL>::ROW + Geo<T, NL>::BROW) + NTH)
         + 16;
}

template <typename T, int NL>
dim3 grid_of(int n) {
  using G = Geo<T, NL>;
  return dim3((n + G::W - 1) / G::W, (n + ROWS - 1) / ROWS);
}

template <typename T, int NL, bool PX>
int launch_geo(const Args<T>& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, NL>();
  static_assert(smem <= 227 * 1024, "a block's shared memory");
  static bool asked = false;   // more than a block gets without asking
  if (smem > 48 * 1024 && !asked) {
    const cudaError_t err = cudaFuncSetAttribute(
        mg_residual_kernel<T, NL, PX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    asked = true;
  }
  const dim3 grid = grid_of<T, NL>(p.n);
  mg_residual_kernel<T, NL, PX><<<grid, NTH, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int NL>
int launch_nl(const Args<T>& p, bool px, cudaStream_t s) {
  return px ? launch_geo<T, NL, true>(p, s) : launch_geo<T, NL, false>(p, s);
}

template <typename T>
int num_blocks(int n, int nl) {
  dim3 g;
  switch (nl) {
    case 1: g = grid_of<T, 1>(n); break;
    case 2: g = grid_of<T, 2>(n); break;
    default: g = grid_of<T, 3>(n); break;   // 32 chunks a row from nl = 3
  }
  return (int)(g.x * g.y);
}

template <typename T>
int launch(const void* a, const void* b, const void* s, const void* lam,
           void* res, void* partial, void* ticket, void* mx, int n, int nl,
           double delta, const double* idh0, const double* idh1,
           double sign_x, double sign_y, int periodic_x, void* stream) {
  if (n < 1 || n > ROWS * 65535 || nl < 1 || nl > MAXNL || !a || !b || !res
      || !partial || !ticket || !mx || !idh0 || !idh1
      || (periodic_x && (n < 8 || n % 2 != 0)))
    return (int)cudaErrorInvalidValue;
  Args<T> p;
  p.a = static_cast<const T*>(a);
  p.b = static_cast<const T*>(b);
  p.s = static_cast<const T*>(s);
  p.lam = static_cast<const T*>(lam);
  p.res = static_cast<T*>(res);
  p.partial = static_cast<T*>(partial);
  p.ticket = static_cast<unsigned*>(ticket);
  p.mx = static_cast<T*>(mx);
  p.n = n;
  const size_t V = 16 / sizeof(T);
  p.vec = n % V == 0
          && ((reinterpret_cast<size_t>(a) | reinterpret_cast<size_t>(b)
               | reinterpret_cast<size_t>(res)) % 16) == 0;
  p.idelta2 = T(1.0 / (delta * delta));
  p.sign_x = T(sign_x);
  p.sign_y = T(sign_y);
  for (int l = 0; l < MAXNL; ++l) {
    p.idh0[l] = l < nl ? T(idh0[l]) : T(0);
    p.idh1[l] = l < nl ? T(idh1[l]) : T(0);
  }
  const bool px = periodic_x != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nl) {
    case 1: return launch_nl<T, 1>(p, px, st);
    case 2: return launch_nl<T, 2>(p, px, st);
    case 3: return launch_nl<T, 3>(p, px, st);
    case 4: return launch_nl<T, 4>(p, px, st);
    case 5: return launch_nl<T, 5>(p, px, st);
    case 6: return launch_nl<T, 6>(p, px, st);
    case 7: return launch_nl<T, 7>(p, px, st);
    case 8: return launch_nl<T, 8>(p, px, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Most layers the kernel takes.
int mg_residual_max_nl() { return MAXNL; }

// Entries of `partial` a launch at (n, nl) of an itemsize (4 or 8) writes:
// one per block.
int mg_residual_num_blocks(int n, int nl, int itemsize) {
  return itemsize == 4 ? num_blocks<float>(n, nl) : num_blocks<double>(n, nl);
}

// a, b and res (nl, n, n); s (nl-1, n) or null; lam (nl, n) or null; partial
// mg_residual_num_blocks values; ticket one unsigned int, 0 before the
// launch and after it; mx the 0-d maximum; idh0 and idh1 host arrays of nl
// doubles; periodic_x needs an even n >= 8; device pointers on `stream`.
// Returns the CUDA error code of the launch (0 on success).
int mg_residual_f32(const void* a, const void* b, const void* s,
                    const void* lam, void* res, void* partial, void* ticket,
                    void* mx, int n, int nl, double delta, const double* idh0,
                    const double* idh1, double sign_x, double sign_y,
                    int periodic_x, void* stream) {
  return launch<float>(a, b, s, lam, res, partial, ticket, mx, n, nl, delta,
                       idh0, idh1, sign_x, sign_y, periodic_x, stream);
}

int mg_residual_f64(const void* a, const void* b, const void* s,
                    const void* lam, void* res, void* partial, void* ticket,
                    void* mx, int n, int nl, double delta, const double* idh0,
                    const double* idh1, double sign_x, double sign_y,
                    int periodic_x, void* stream) {
  return launch<double>(a, b, s, lam, res, partial, ticket, mx, n, nl, delta,
                        idh0, idh1, sign_x, sign_y, periodic_x, stream);
}

const char* mg_residual_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
