// Basis-matmul spectral solve for Hopper (sm_90a): kernel K7 of the port.
//
// Replaces the Pallas TPU kernel `_kernel` (msom_tpu/solvers/pallas_spectral.py,
// entry `fused_mm_solve`), which computes for every modal layer l
//
//   psi_m[l] = S^T ( ( S (q_m[l] S^T) ) * D[l] ) S
//
// with S the (N, N) orthonormal DST-II basis and D the inverse modal
// denominators: four N x N products and one elementwise scale.
//
// Design. On the TPU a layer's N^2 intermediates stay in VMEM; on the H100 a
// 1024^2 f32 plane is 4 MB against 227 KB of shared memory, so the chain is
// not carried over block by block. It is ONE hand-written tiled GEMM kernel,
// launched four times a solve over all layers (blockIdx.z = layer):
//
//   C[l] = (op(A[l]) op(B[l])) * D[l]        (D optional)
//
// The transposes are taken in the index maps of the tile loads (no
// transposed copy is ever made), S is shared by the layers through a layer
// stride of 0, and the `* D[l]` scale is fused into the epilogue of the
// second product. The intermediates make one round trip through device
// memory (L2 holds much of a 4 MB plane). Each block computes a 128 x 128
// tile of C with 256 threads, 8 x 8 outputs a thread, over K tiles of 8 held
// in two shared-memory buffers: the next tile's loads are in flight while
// the current one is multiplied, with one barrier a tile.
//
// Precision. Full FP32 FMAs on the FP32 pipe with FP32 accumulation (FP64
// in the f64 build): no tensor cores, no TF32 or bf16 pass. The TPU
// kernel's 3-pass bf16 split stands in for Precision.HIGH; full FP32 is at
// least that error class. A 1-pass reduced-precision transform gives O(1)
// solution error at N = 2048 through the Poisson conditioning.
//
// Gate. N a multiple of 128 (the wrapper takes 128 <= N <= 1024 like the
// TPU kernel), so no tile is partial and every 4-element access is aligned.
//
// Bound. Operations: 4 products * 2 N^3 * nl; at 1024^2 x 4 that is 34.4
// GFLOP, 0.51 ms at the 67 TFLOP/s of the FP32 pipe, against 54 MB of
// compulsory traffic (S, q_m, D in, psi_m out: 0.016 ms). Operations bound
// it.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 8;   // block tile
constexpr int TM = 8, TN = 8;               // outputs per thread
constexpr int NTH = (BM / TM) * (BN / TN);  // 256 threads
constexpr int LD = BM + 4;                  // padded row of a staged tile
constexpr int EPT = BM * BK / NTH;          // tile elements a thread loads

static_assert(BM == BN, "one loader serves both operands");
static_assert(BM * BK % NTH == 0, "whole elements per thread");

template <typename T>
__device__ __forceinline__ void load4(const T* p, T* r) {
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  } else {
    const double2 a = *reinterpret_cast<const double2*>(p);
    const double2 b = *reinterpret_cast<const double2*>(p + 2);
    r[0] = a.x; r[1] = a.y; r[2] = b.x; r[3] = b.y;
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const T* r) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    *reinterpret_cast<double2*>(p) = make_double2(r[0], r[1]);
    *reinterpret_cast<double2*>(p + 2) = make_double2(r[2], r[3]);
  }
}

// Load this thread's EPT elements of the (BK x BM) tile t[k][m] =
// X(m0 + m, k0 + k) of an operand held row-major in `src` (N x N).
// KMAJOR: X(m, k) = src[k * N + m] (m runs along a row of src);
// otherwise X(m, k) = src[m * N + k] (k runs along a row of src).
// Either way neighbouring threads read neighbouring addresses.
template <typename T, bool KMAJOR>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int N,
                                          int m0, int k0, int tid, T* reg) {
#pragma unroll
  for (int r = 0; r < EPT; ++r) {
    const int e = tid + r * NTH;
    if (KMAJOR) {
      const int m = e % BM, k = e / BM;
      reg[r] = src[(size_t)(k0 + k) * N + m0 + m];
    } else {
      const int k = e % BK, m = e / BK;
      reg[r] = src[(size_t)(m0 + m) * N + k0 + k];
    }
  }
}

// Store them into the staged tile t[k][m] (row stride LD; the padding keeps
// the transposing store of the non-KMAJOR case free of bank conflicts).
template <typename T, bool KMAJOR>
__device__ __forceinline__ void store_tile(T* t, int tid, const T* reg) {
#pragma unroll
  for (int r = 0; r < EPT; ++r) {
    const int e = tid + r * NTH;
    const int m = KMAJOR ? e % BM : e / BK;
    const int k = KMAJOR ? e / BM : e % BK;
    t[k * LD + m] = reg[r];
  }
}

// C[l] = (op(A[l]) op(B[l])) * D[l] with op(A)(i, k) = TA ? A[k][i] : A[i][k]
// and op(B)(k, j) = TB ? B[j][k] : B[k][j]; D may be null. Layer strides in
// elements (0 shares one matrix between the layers).
template <typename T, bool TA, bool TB>
__global__ void __launch_bounds__(NTH)
gemm_kernel(const T* __restrict__ A, size_t strideA,
            const T* __restrict__ B, size_t strideB,
            const T* __restrict__ D, T* __restrict__ C, int N) {
  __shared__ __align__(16) T As[2][BK * LD];
  __shared__ __align__(16) T Bs[2][BK * LD];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN, l = blockIdx.z;
  const size_t NN = (size_t)N * N;
  A += l * strideA;
  B += l * strideB;

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

  // op(A)(i, k) runs along i in memory when A is transposed; op(B)(k, j)
  // runs along j when B is not.
  T ra[EPT], rb[EPT];
  load_tile<T, TA>(A, N, i0, 0, tid, ra);
  load_tile<T, !TB>(B, N, j0, 0, tid, rb);
  store_tile<T, TA>(As[0], tid, ra);
  store_tile<T, !TB>(Bs[0], tid, rb);
  __syncthreads();

  const int nk = N / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_tile<T, TA>(A, N, i0, (kt + 1) * BK, tid, ra);
      load_tile<T, !TB>(B, N, j0, (kt + 1) * BK, tid, rb);
    }
    const T* as = As[cur];
    const T* bs = Bs[cur];
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      // rows ty*4.. and 64 + ty*4.., columns tx*4.. and 64 + tx*4..
      T a[TM], b[TN];
      load4(as + k * LD + ty * 4, a);
      load4(as + k * LD + BM / 2 + ty * 4, a + 4);
      load4(bs + k * LD + tx * 4, b);
      load4(bs + k * LD + BN / 2 + tx * 4, b + 4);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    if (kt + 1 < nk) {
      store_tile<T, TA>(As[cur ^ 1], tid, ra);
      store_tile<T, !TB>(Bs[cur ^ 1], tid, rb);
    }
    __syncthreads();
  }

  // epilogue: the optional scale, then 4-element stores
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = i0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = j0 + h * (BN / 2) + tx * 4;
      const size_t o = l * NN + (size_t)row * N + col;
      T v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                acc[i][4 * h + 3]};
      if (D != nullptr) {
        T d[4];
        load4(D + o, d);
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] *= d[j];
      }
      store4(C + o, v);
    }
  }
}

template <typename T, bool TA, bool TB>
int launch_one(const void* A, long long strideA, const void* B,
               long long strideB, const void* D, void* C, int N, int nl,
               void* stream) {
  const dim3 grid(N / BN, N / BM, nl), block(NTH);
  gemm_kernel<T, TA, TB><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), (size_t)strideA, static_cast<const T*>(B),
      (size_t)strideB, static_cast<const T*>(D), static_cast<T*>(C), N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* A, long long strideA, int transA, const void* B,
           long long strideB, int transB, const void* D, void* C, int N,
           int nl, void* stream) {
  if (N < BM || N % BM != 0 || nl < 1 || nl > 65535 || !A || !B || !C
      || strideA < 0 || strideB < 0)
    return (int)cudaErrorInvalidValue;
  if (transA)
    return transB
        ? launch_one<T, true, true>(A, strideA, B, strideB, D, C, N, nl, stream)
        : launch_one<T, true, false>(A, strideA, B, strideB, D, C, N, nl, stream);
  return transB
      ? launch_one<T, false, true>(A, strideA, B, strideB, D, C, N, nl, stream)
      : launch_one<T, false, false>(A, strideA, B, strideB, D, C, N, nl, stream);
}

}  // namespace

extern "C" {

// One product of the chain over all nl layers:
// C[l] = (op(A[l]) op(B[l])) * D[l], N x N row-major matrices, layer
// strides in elements (0 for a matrix shared by the layers), trans != 0
// transposes that operand, D (nl, N, N) or null; N a multiple of the 128-cell
// tile. Device pointers, launched on `stream`; returns the CUDA error code of
// the launch (0 on success).
int fused_spectral_gemm_f32(const void* A, long long strideA, int transA,
                            const void* B, long long strideB, int transB,
                            const void* D, void* C, int N, int nl,
                            void* stream) {
  return launch<float>(A, strideA, transA, B, strideB, transB, D, C, N, nl,
                       stream);
}

int fused_spectral_gemm_f64(const void* A, long long strideA, int transA,
                            const void* B, long long strideB, int transB,
                            const void* D, void* C, int N, int nl,
                            void* stream) {
  return launch<double>(A, strideA, transA, B, strideB, transB, D, C, N, nl,
                        stream);
}

const char* fused_spectral_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
