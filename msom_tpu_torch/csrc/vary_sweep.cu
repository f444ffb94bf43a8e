// Block-Thomas y-sweeps of the y-profile direct solve for Hopper (sm_90a):
// kernel KV of the port.
//
// Replaces no Pallas kernel: the JAX package runs these sweeps as two
// `lax.scan`s over y (msom_tpu/solvers/vary.py:270-291, `fwd` and `bwd`,
// unroll 16), which XLA compiles on the TPU. For each of the Kx columns k
// (x-modes of the DST) independently, with W_j the (nl, nl) block inverses
// of row j (planes last: W[a][b][j][k]) and a = 1/h^2:
//
//   forward:   y_j   = W_j (x_j - a y_{j-1}),   j = 0 .. N-1,  y_{-1} = 0
//   backward:  psi_j = y_j - a W_j psi_{j+1},   j = N-1 .. 0,  psi_N = 0
//
// Bound. Bytes: W read by each sweep (at 2048^2 x 4 f32 W is 268 MB, far
// more than the 50 MB L2), x read, y written and read back, psi written:
// (2 nl^2 + 4 nl) N Kx values, 805 MB or 0.240 ms at 3.35 TB/s. About
// 4 nl^2 + 4 nl operations a row and column, 0.004 ms at 67 TFLOP/s: bytes
// bound it. The only serial dependency is the nl-vector carry from one row
// to the next, so the loads can run many rows ahead of it.
//
// Design. One thread owns one column k and runs its whole chain with the
// carry in registers; a block is one warp of 32 adjacent columns, so each
// plane's row is one coalesced 128-byte (f32) line. Each thread copies its
// own values of a row (the nl^2 W planes and the nl right-hand-side
// planes) into a ring of D rows in shared memory with `cp.async`, D - 1
// rows ahead of the row it computes, so about D rows of loads are in
// flight while the carry advances. No thread reads another's copies, so
// the ring needs no barrier: `cp.async.wait_group` alone orders a row's
// copies before its use, and a slot is refilled only after the thread has
// consumed it. The forward and backward sweeps are two launches of one
// template (y is written by the first and read by the second).
//
// What holds it back: Kx chains are all the parallelism there is, 2048
// threads (64 warps) at 2048^2, one warp per SM on half the SMs, so the
// rate is one warp's instruction issue per row (about 2 nl^2 + 2 nl
// copies, shared loads and FMAs a row), not the memory.

#include <cuda_runtime.h>

namespace {

constexpr int BK = 32;                 // columns (threads) per block
constexpr int MAXNL = 8;
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

template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One sweep over the N rows of every column: forward (BWD false) reads x
// as `rhs` and writes y to `out`; backward reads y as `rhs` and writes psi.
template <typename T, int NL, bool BWD>
__global__ void __launch_bounds__(BK)
    sweep_kernel(const T* __restrict__ W, const T* __restrict__ rhs,
                 T* __restrict__ out, int N, int K, T a) {
  constexpr int NB = NL * NL;           // W planes
  constexpr int P = NB + NL;            // planes a row
  constexpr int D = ring_depth<T, NL>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);   // [D][P][BK]
  const int t = threadIdx.x;
  const int k = blockIdx.x * BK + t;
  const bool live = k < K;
  const size_t NK = (size_t)N * K;

  // copy the row of step s (forward j = s, backward j = N-1-s) into its
  // slot; one commit group a step, empty past the last row
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
    issue(s + D - 1);            // refills the slot consumed at step s - 1
    cp_async_wait<D - 1>();      // the row of step s has landed
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
int launch_nl(const T* W, const T* X, T* Y, T* Psi, int N, int K, T a,
              cudaStream_t s) {
  constexpr int P = NL * NL + NL;
  constexpr int D = ring_depth<T, NL>();
  const size_t smem = (size_t)D * P * BK * sizeof(T);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        sweep_kernel<T, NL, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(sweep_kernel<T, NL, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((K + BK - 1) / BK);
  sweep_kernel<T, NL, false><<<grid, BK, smem, s>>>(W, X, Y, N, K, a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sweep_kernel<T, NL, true><<<grid, BK, smem, s>>>(W, Y, Psi, N, K, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* W, const void* X, void* Y, void* Psi, int nl, int N,
           int K, double a, void* stream) {
  if (N < 1 || K < 1 || !W || !X || !Y || !Psi || Y == X || Psi == Y)
    return (int)cudaErrorInvalidValue;
  const T* w = static_cast<const T*>(W);
  const T* x = static_cast<const T*>(X);
  T* y = static_cast<T*>(Y);
  T* psi = static_cast<T*>(Psi);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nl) {
    case 2: return launch_nl<T, 2>(w, x, y, psi, N, K, T(a), s);
    case 3: return launch_nl<T, 3>(w, x, y, psi, N, K, T(a), s);
    case 4: return launch_nl<T, 4>(w, x, y, psi, N, K, T(a), s);
    case 5: return launch_nl<T, 5>(w, x, y, psi, N, K, T(a), s);
    case 6: return launch_nl<T, 6>(w, x, y, psi, N, K, T(a), s);
    case 7: return launch_nl<T, 7>(w, x, y, psi, N, K, T(a), s);
    case 8: return launch_nl<T, 8>(w, x, y, psi, N, K, T(a), s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Most layers the kernel takes (at least 2).
int vary_sweep_max_nl() { return MAXNL; }

// W (nl, nl, N, K), X, Y, Psi (nl, N, K), contiguous device arrays; Y is
// scratch (the forward sweep's output), Psi the result. Launches the
// forward and the backward sweep on `stream`; returns the CUDA error code
// (0 on success).
int vary_sweep_f32(const void* W, const void* X, void* Y, void* Psi, int nl,
                   int N, int K, double a, void* stream) {
  return launch<float>(W, X, Y, Psi, nl, N, K, a, stream);
}

int vary_sweep_f64(const void* W, const void* X, void* Y, void* Psi, int nl,
                   int N, int K, double a, void* stream) {
  return launch<double>(W, X, Y, Psi, nl, N, K, a, stream);
}

const char* vary_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
