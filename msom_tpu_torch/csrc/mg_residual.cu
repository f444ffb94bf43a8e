// Fused layered residual and its max norm for Hopper (sm_90a): kernel K4 of
// the port.
//
// Replaces the Pallas TPU kernel `_residual_kernel`
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
// Design: one block computes a 32-column tile of TY rows of all nl layers
// (TY = 128 at nl = 1, 64 at nl = 2, 32 above, so that a block's work does
// not shrink with nl): it stages a on a one-cell halo in shared memory (the
// ghosts applied as it stages), then each of its 256 threads holds a cell's
// column in registers (nl is a template parameter) for the vertical
// coupling, TY / 8 rows a thread; b is read and res written once, 128
// bytes a warp. tools/k3_variants.py times this tile against 32-row tiles
// at every nl and against K1's row march (a ring of a's and b's rows fed by
// cp.async, one barrier a row, 16-byte accesses; its source is in the
// tool), which was faster at nl = 1 and slower from nl = 3 on (PERF.md).
//
// The max norm in the same launch: each block reduces its cells' maximum
// (through shared memory) into its slot of `partial`; then its thread 0
// makes the slot visible (__threadfence) and takes a ticket (atomicAdd).
// The block that draws the last ticket reduces all slots into the 0-d
// result and sets the ticket back to 0 for the next launch. The reduction
// carries a NaN once it has seen one, as the plain version's max does; max
// is exact, so the result does not depend on the blocks' order.
//
// Bound. Bytes: a and b read, res written, 3 * nl * n^2 values; at
// 2048^2 x 4 in f32 201 MB, 0.060 ms at 3.35 TB/s. About 15 operations per
// cell and layer, 3.8 us at 67 TFLOP/s: bytes bound it. The tile reads a's
// halo as well: (TY + 2) * 34 / (32 * TY) of a's plane, from L2 where a
// neighbour has read it.

#include <cuda_runtime.h>

namespace {

constexpr int MAXNL = 8;
constexpr int NTH = 256;           // threads a block
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
  T idelta2, sign_x, sign_y;
  T idh0[MAXNL], idh1[MAXNL];
};

// max that keeps a NaN: m stays NaN once it is, and takes a NaN v
template <typename T>
__device__ __forceinline__ T nanmax(T m, T v) {
  return (v > m || v != v) ? v : m;
}

// The tile of a type and nl: 32 columns and TY rows of all layers (128 rows
// at nl = 1, 64 at nl = 2, 32 above: a block's work does not shrink with
// nl); BX x BY threads, RPT rows a thread.
template <typename T, int NL>
struct Geo {
  static constexpr int TX = 32, BX = 32, BY = NTH / 32;
  static constexpr int TY = NL == 1 ? 128 : (NL == 2 ? 64 : 32);
  static constexpr int RPT = TY / BY;
  static constexpr int HW = TX + 2, HH = TY + 2;   // a's plane with its halo
  static constexpr int HSZ = HW * HH;
};

template <typename T, int NL, bool PX>
__global__ void __launch_bounds__(NTH) mg_residual_kernel(const Args<T> p) {
  using G = Geo<T, NL>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sa = reinterpret_cast<T*>(smem_raw);      // NL planes of HH x HW
  T* red = sa + NL * G::HSZ;                   // NTH block maxima
  int* last = reinterpret_cast<int*>(red + NTH);
  const int n = p.n, tid = threadIdx.x;
  const int x0 = blockIdx.x * G::TX, y0 = blockIdx.y * G::TY;
  const size_t nn = (size_t)n * n;

  // stage a with its halo. Walls: ghost = sign * edge cell per axis; cells
  // further out (partial tiles) clamp to the wall and feed no output. PX:
  // x wraps, rows -1 and n are rows 7 and n - 8.
  for (int k = tid; k < G::HSZ; k += NTH) {
    int gy = y0 - 1 + k / G::HW, gx = x0 - 1 + k % G::HW;
    T sg = T(1);
    if (PX) {
      gy = gy < 0 ? 7 : (gy == n ? n - 8 : (gy > n ? n - 1 : gy));
      gx = ((gx % n) + n) % n;
    } else {
      if (gy < 0) {
        gy = 0;
        sg *= p.sign_y;
      } else if (gy >= n) {
        gy = n - 1;
        sg *= p.sign_y;
      }
      if (gx < 0) {
        gx = 0;
        sg *= p.sign_x;
      } else if (gx >= n) {
        gx = n - 1;
        sg *= p.sign_x;
      }
    }
    const size_t cell = (size_t)gy * n + gx;
#pragma unroll
    for (int l = 0; l < NL; ++l)
      sa[l * G::HSZ + k] = sg * __ldg(p.a + l * nn + cell);
  }
  __syncthreads();

  T m = T(0);
  const int ox = tid % G::BX, oyt = tid / G::BX, gx = x0 + ox;
#pragma unroll
  for (int rr = 0; rr < G::RPT; ++rr) {
    const int oy = oyt + G::BY * rr, gy = y0 + oy;
    if (gy >= n || gx >= n) continue;
    const size_t cell = (size_t)gy * n + gx;
    const T* c = sa + (oy + 1) * G::HW + ox + 1;
    T cur[NL], rs[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const T* cl = c + l * G::HSZ;
      cur[l] = cl[0];
      const T lap = ((((cl[1] + cl[-1]) + cl[G::HW]) + cl[-G::HW])
                     - T(4) * cur[l]) * p.idelta2;
      rs[l] = __ldg(p.b + l * nn + cell) - lap;
    }
    if (NL > 1 && p.s != nullptr) {
      T up[NL];
#pragma unroll
      for (int l = 0; l < NL - 1; ++l)
        up[l] = __ldg(p.s + l * n + gy) * (cur[l] - cur[l + 1]);
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        T g;
        if (l == 0)
          g = -up[0] * p.idh1[0];
        else if (l == NL - 1)
          g = up[l - 1] * p.idh0[l];
        else
          g = up[l - 1] * p.idh0[l] - up[l] * p.idh1[l];
        rs[l] -= g;
      }
    }
    if (p.lam != nullptr) {
#pragma unroll
      for (int l = 0; l < NL; ++l)
        rs[l] -= __ldg(p.lam + l * n + gy) * cur[l];
    }
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      p.res[l * nn + cell] = rs[l];
      m = nanmax(m, rs[l] < T(0) ? -rs[l] : rs[l]);
    }
  }

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
  return sizeof(T) * (NL * Geo<T, NL>::HSZ + NTH) + 16;
}

template <typename T, int NL>
dim3 grid_of(int n) {
  using G = Geo<T, NL>;
  return dim3((n + G::TX - 1) / G::TX, (n + G::TY - 1) / G::TY);
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
    default: g = grid_of<T, 3>(n); break;   // 32-row tiles from nl = 3
  }
  return (int)(g.x * g.y);
}

template <typename T>
int launch(const void* a, const void* b, const void* s, const void* lam,
           void* res, void* partial, void* ticket, void* mx, int n, int nl,
           double delta, const double* idh0, const double* idh1,
           double sign_x, double sign_y, int periodic_x, void* stream) {
  if (n < 1 || n > 32 * 65535 || nl < 1 || nl > MAXNL || !a || !b || !res
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
