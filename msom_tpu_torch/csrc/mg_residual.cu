// Fused layered residual and its max norm for Hopper (sm_90a): kernel K4 of
// the port.
//
// Replaces the Pallas TPU kernel `_residual_kernel`
// (msom_tpu/solvers/pallas_mg.py, entry `residual_norm`) on walled levels
// whose coefficients are y-profiles. In one pass over device memory
//
//   res[l] = b[l] - lap(a[l]) - Gamma(a)[l] - lam[l] * a[l]
//   Gamma(a)[l] = up[l-1] * idh0[l] - up[l] * idh1[l],
//   up[l] = s[l] * (a[l] - a[l+1])
//
// (poisson_layer.h:157-258) and max|res|. s (nl-1, n) and lam (nl, n) are
// y-profiles, read per row, each optional (a null pointer); the wall ghost of
// a is sign * edge cell, Dirichlet -1 / Neumann +1.
//
// Design. One block computes a TY x TX tile of all nl layers: it stages a on
// a one-cell halo in shared memory, then each thread holds its cell's column
// in registers (nl is a template parameter) for the vertical coupling. The
// TPU kernel's grid is sequential and writes row i of a per-tile output;
// here blocks run in no order, so each block reduces its own maximum (warp
// shuffles, then shared memory) into its slot of `partial`, and the caller
// takes one amax over the slots. The reduction carries a NaN once it has
// seen one, as the plain version's max does.
//
// Bound. Bytes: a and b read, res written, 3 * nl * n^2 values; at
// 2048^2 x 4 in f32 201 MB, 0.060 ms at 3.35 TB/s. About 15 operations per
// cell and layer, 3.8 us at 67 TFLOP/s: bytes bound it.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32, TY = 32;          // outputs per block
constexpr int BX = 32, BY = 8;           // threads per block
constexpr int RPT = TY / BY;             // output rows per thread
constexpr int NTH = BX * BY;
constexpr int HW = TX + 2, HH = TY + 2;  // a plane with its 1-cell halo
constexpr int HSZ = HW * HH;
constexpr int MAXNL = 8;

template <typename T>
struct Args {
  const T* a;
  const T* b;
  const T* s;     // (nl-1, n) or null
  const T* lam;   // (nl, n) or null
  T* res;
  T* partial;     // one maximum per block
  int n;
  T idelta2, sign_x, sign_y;
  T idh0[MAXNL], idh1[MAXNL];
};

// max that keeps a NaN: m stays NaN once it is, and takes a NaN v
template <typename T>
__device__ __forceinline__ T nanmax(T m, T v) {
  return (v > m || v != v) ? v : m;
}

template <typename T, int NL>
__global__ void __launch_bounds__(NTH) residual_kernel(const Args<T> p) {
  extern __shared__ unsigned char smem_raw[];
  T* sa = reinterpret_cast<T*>(smem_raw);   // NL planes of HH x HW
  __shared__ T swarp[NTH / 32];
  const int n = p.n;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * BX + threadIdx.x;
  const size_t nn = (size_t)n * n;

  // stage a with its halo: ghosts = sign * edge cell per reflected axis;
  // cells further out (partial tiles) clamp to the wall and feed no output
  for (int k = tid; k < HSZ; k += NTH) {
    int gy = y0 - 1 + k / HW, gx = x0 - 1 + k % HW;
    T sg = T(1);
    if (gy < 0) { gy = 0; sg *= p.sign_y; }
    else if (gy >= n) { gy = n - 1; sg *= p.sign_y; }
    if (gx < 0) { gx = 0; sg *= p.sign_x; }
    else if (gx >= n) { gx = n - 1; sg *= p.sign_x; }
    const size_t cell = (size_t)gy * n + gx;
#pragma unroll
    for (int l = 0; l < NL; ++l)
      sa[l * HSZ + k] = sg * __ldg(p.a + l * nn + cell);
  }
  __syncthreads();

  T m = T(0);
  const int ox = threadIdx.x, gx = x0 + ox;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int oy = threadIdx.y + BY * r, gy = y0 + oy;
    if (gy >= n || gx >= n) continue;
    const size_t cell = (size_t)gy * n + gx;
    const T* c = sa + (oy + 1) * HW + ox + 1;
    T cur[NL], rs[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const T* cl = c + l * HSZ;
      cur[l] = cl[0];
      const T lap = ((((cl[1] + cl[-1]) + cl[HW]) + cl[-HW])
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

  // the block's maximum: within each warp, then across the warps
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nanmax(m, __shfl_down_sync(0xffffffffu, m, off));
  if ((tid & 31) == 0) swarp[tid >> 5] = m;
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int w = 1; w < NTH / 32; ++w) m = nanmax(m, swarp[w]);
    p.partial[blockIdx.y * gridDim.x + blockIdx.x] = m;
  }
}

template <typename T, int NL>
int launch_nl(const Args<T>& p, cudaStream_t stream) {
  const size_t smem = sizeof(T) * NL * HSZ;
  if (smem > 48 * 1024) {   // more than a block gets without asking
    cudaError_t err = cudaFuncSetAttribute(
        residual_kernel<T, NL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int nb = (p.n + TX - 1) / TX;
  residual_kernel<T, NL><<<dim3(nb, nb), dim3(BX, BY), smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* a, const void* b, const void* s, const void* lam,
           void* res, void* partial, int n, int nl, double delta,
           const double* idh0, const double* idh1, double sign_x,
           double sign_y, void* stream) {
  if (n < 1 || n > 32 * 65535 || nl < 1 || nl > MAXNL || !a || !b || !res
      || !partial || !idh0 || !idh1)
    return (int)cudaErrorInvalidValue;
  Args<T> p;
  p.a = static_cast<const T*>(a);
  p.b = static_cast<const T*>(b);
  p.s = static_cast<const T*>(s);
  p.lam = static_cast<const T*>(lam);
  p.res = static_cast<T*>(res);
  p.partial = static_cast<T*>(partial);
  p.n = n;
  p.idelta2 = T(1.0 / (delta * delta));
  p.sign_x = T(sign_x);
  p.sign_y = T(sign_y);
  for (int l = 0; l < MAXNL; ++l) {
    p.idh0[l] = l < nl ? T(idh0[l]) : T(0);
    p.idh1[l] = l < nl ? T(idh1[l]) : T(0);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nl) {
    case 1: return launch_nl<T, 1>(p, st);
    case 2: return launch_nl<T, 2>(p, st);
    case 3: return launch_nl<T, 3>(p, st);
    case 4: return launch_nl<T, 4>(p, st);
    case 5: return launch_nl<T, 5>(p, st);
    case 6: return launch_nl<T, 6>(p, st);
    case 7: return launch_nl<T, 7>(p, st);
    case 8: return launch_nl<T, 8>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Most layers the kernel takes.
int mg_residual_max_nl() { return MAXNL; }

// Entries of `partial` a launch at this n writes (one per block).
int mg_residual_num_blocks(int n) {
  const int nb = (n + TX - 1) / TX;
  return nb * nb;
}

// a, b and res (nl, n, n); s (nl-1, n) or null; lam (nl, n) or null; partial
// mg_residual_num_blocks(n) values; idh0 and idh1 host arrays of nl doubles;
// device pointers on `stream`. Returns the CUDA error code of the launch (0
// on success).
int mg_residual_f32(const void* a, const void* b, const void* s,
                    const void* lam, void* res, void* partial, int n, int nl,
                    double delta, const double* idh0, const double* idh1,
                    double sign_x, double sign_y, void* stream) {
  return launch<float>(a, b, s, lam, res, partial, n, nl, delta, idh0, idh1,
                       sign_x, sign_y, stream);
}

int mg_residual_f64(const void* a, const void* b, const void* s,
                    const void* lam, void* res, void* partial, int n, int nl,
                    double delta, const double* idh0, const double* idh1,
                    double sign_x, double sign_y, void* stream) {
  return launch<double>(a, b, s, lam, res, partial, n, nl, delta, idh0, idh1,
                        sign_x, sign_y, stream);
}

const char* mg_residual_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
