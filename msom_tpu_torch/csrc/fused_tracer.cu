// Fused passive-tracer tendency for Hopper (sm_90a): kernel K2 of the port.
//
// Replaces the Pallas TPU kernel `_tracer_kernel`
// (msom_tpu/models/pallas_rhs.py, entry `tracer_fused`) for walled domains.
// For the nl * nptr tracer planes c_k, k = l * nptr + j (the flattening of
// the (nl, nptr, N, N) state: layer l = k / nptr, tracer j = k % nptr), it
// computes in one pass over device memory
//
//   dtr_k = -J(psi_l, c_k) + iPe_j * lap(c_k) + ir_j * (relax_k - c_k)
//
// (ptr_rhs, msqg/qg.h:573-588), or -ir_j * c_k without a relaxation field.
// -J is the 12-point Arakawa bracket. psi has Dirichlet ghosts (ghost =
// -interior, corners +interior), the tracers Neumann ghosts (ghost =
// +interior on both axes, corners included).
//
// Design. One block computes a TY x TX tile of one layer: it stages psi_l on
// a 1-cell halo in shared memory once, then walks that layer's nptr tracers,
// staging each c_k on a 1-cell halo and writing its tile of dtr_k. Nothing
// derived needs a ghost ring here, so one halo cell is enough.
//
// Where it is likely to go wrong: the (l, j) order of the flattened planes
// (the layer of plane k is k / nptr, its coefficients those of k % nptr) and
// the two different ghost signs; chip_smoke.py and tests/test_torch_cuda.py
// hold the kernel against the plain version with distinct per-tracer
// coefficients.
//
// Bound. Bytes: psi (nl planes) and the tracers (nl * nptr) read, dtr
// (nl * nptr) written, the relaxation field (nl * nptr) read where there is
// one; at 2048^2 x 4 with 2 tracers in f32, 20 planes = 335 MB, about 100 us
// at 3.35 TB/s. The arithmetic is about 45 operations per cell and plane
// (one bracket, one Laplacian, the relaxation), about 20 us at 67 TFLOP/s:
// bytes bound it.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32, TY = 32;          // outputs per block
constexpr int BX = 32, BY = 8;           // threads per block
constexpr int RPT = TY / BY;             // output rows per thread
constexpr int NTH = BX * BY;
constexpr int HW = TX + 2, HH = TY + 2;  // a plane with its 1-cell halo
constexpr int HSZ = HW * HH;
constexpr int MAXTR = 16;                // most tracers per layer

struct Params {
  int N, nl, nptr;
  double delta;
  double iPe[MAXTR], ir[MAXTR];
};

// Stage the tile of one (N, N) plane with a 1-cell halo: interior cells as
// they are, ghosts = sign * interior per reflected axis. Cells further out
// (partial tiles only) clamp to the wall cell and feed no output.
template <typename T>
__device__ void stage(T* dst, const T* __restrict__ src, int y0, int x0, int N,
                      int tid, T sign) {
  for (int k = tid; k < HSZ; k += NTH) {
    int gy = y0 - 1 + k / HW, gx = x0 - 1 + k % HW;
    T s = T(1);
    if (gy < 0) { gy = 0; s *= sign; } else if (gy >= N) { gy = N - 1; s *= sign; }
    if (gx < 0) { gx = 0; s *= sign; } else if (gx >= N) { gx = N - 1; s *= sign; }
    dst[k] = s * src[(size_t)gy * N + gx];
  }
}

template <typename T>
__global__ void __launch_bounds__(NTH)
tracer_kernel(const T* __restrict__ psi, const T* __restrict__ tr,
              const T* __restrict__ relax, T* __restrict__ dtr,
              const Params p) {
  __shared__ T sp[HSZ];   // psi_l
  __shared__ T sc[HSZ];   // c_k
  const int N = p.N, l = blockIdx.z;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * BX + threadIdx.x;
  const size_t NN = (size_t)N * N;
  const T id2 = T(1.0 / (p.delta * p.delta));
  const T i12d2 = T(1.0 / (12.0 * p.delta * p.delta));

  stage(sp, psi + l * NN, y0, x0, N, tid, T(-1));
  for (int j = 0; j < p.nptr; ++j) {
    const size_t plane = ((size_t)l * p.nptr + j) * NN;
    __syncthreads();   // the last tracer's readers are done with sc
    stage(sc, tr + plane, y0, x0, N, tid, T(1));
    __syncthreads();
    const int ox = threadIdx.x, gx = x0 + ox;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int oy = threadIdx.y + BY * r, gy = y0 + oy;
      const T* P = sp + (oy + 1) * HW + ox + 1;
      const T* C = sc + (oy + 1) * HW + ox + 1;
      const T pE = P[1], pW = P[-1], pN = P[HW], pS = P[-HW];
      const T pNE = P[HW + 1], pNW = P[HW - 1];
      const T pSE = P[-HW + 1], pSW = P[-HW - 1];
      const T qE = C[1], qW = C[-1], qN = C[HW], qS = C[-HW];
      const T qNE = C[HW + 1], qNW = C[HW - 1];
      const T qSE = C[-HW + 1], qSW = C[-HW - 1];
      const T jac = (qE - qW) * (pN - pS) + (qS - qN) * (pE - pW)
                  + qE * (pNE - pSE) - qW * (pNW - pSW)
                  - qN * (pNE - pNW) + qS * (pSE - pSW)
                  + pN * (qNE - qNW) - pS * (qSE - qSW)
                  - pE * (qNE - qSE) + pW * (qNW - qSW);
      const T lap = (qE + qW + qN + qS - T(4) * C[0]) * id2;
      if (gy < N && gx < N) {
        const size_t o = plane + (size_t)gy * N + gx;
        const T tgt = relax != nullptr ? relax[o] - C[0] : -C[0];
        dtr[o] = jac * i12d2 + T(p.iPe[j]) * lap + T(p.ir[j]) * tgt;
      }
    }
  }
}

template <typename T>
int launch(const void* psi, const void* tr, const void* relax, void* dtr,
           int N, int nl, int nptr, double delta, const double* iPe,
           const double* ir, void* stream) {
  if (nl < 1 || nl > 65535 || nptr < 1 || nptr > MAXTR || N < 1
      || !psi || !tr || !dtr)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.N = N;
  p.nl = nl;
  p.nptr = nptr;
  p.delta = delta;
  for (int j = 0; j < MAXTR; ++j) {
    p.iPe[j] = j < nptr ? iPe[j] : 0.0;
    p.ir[j] = j < nptr ? ir[j] : 0.0;
  }
  const dim3 grid((N + TX - 1) / TX, (N + TY - 1) / TY, nl), block(BX, BY);
  tracer_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(psi), static_cast<const T*>(tr),
      static_cast<const T*>(relax), static_cast<T*>(dtr), p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Most tracers per layer the kernel takes.
int fused_tracer_max_nptr() { return MAXTR; }

// psi (nl, N, N), tr and dtr (nl * nptr, N, N), relax the same or null;
// iPe and ir host arrays of nptr doubles; device pointers on `stream`.
// Returns the CUDA error code of the launch (0 on success).
int fused_tracer_f32(const void* psi, const void* tr, const void* relax,
                     void* dtr, int N, int nl, int nptr, double delta,
                     const double* iPe, const double* ir, void* stream) {
  return launch<float>(psi, tr, relax, dtr, N, nl, nptr, delta, iPe, ir,
                       stream);
}

int fused_tracer_f64(const void* psi, const void* tr, const void* relax,
                     void* dtr, int N, int nl, int nptr, double delta,
                     const double* iPe, const double* ir, void* stream) {
  return launch<double>(psi, tr, relax, dtr, N, nl, nptr, delta, iPe, ir,
                        stream);
}

const char* fused_tracer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
