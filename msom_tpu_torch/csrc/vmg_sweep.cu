// Masked red-black vertical-line relaxation sweep on the vertex grid for
// Hopper (sm_90a): kernel K6 of the port.
//
// Replaces the Pallas TPU kernel `_vsweep_kernel`
// (msom_tpu/solvers/pallas_vmg.py, entry `vrb_sweep`): one launch is one full
// sweep of the vertex multigrid's smoother (solvers/vmg.py relax_v), for the
// red nodes ((row + column) even), then for the black nodes on the result of
// the red pass, per node
//
//   rhs[l] = (-d2 * res[l] + (E + W + N + S of da[l])) * mask
//   dp[0]  = rhs[0] * im[0];  dp[l] = (rhs[l] - t0[l] * dp[l-1]) * im[l]
//   x[nl-1] = dp[nl-1];       x[l]  = dp[l] - cp[l] * x[l+1]
//   da[l]  = x[l] * mask
//
// the exact solve of the column's vertical tridiagonal system with the
// horizontal neighbours frozen (qg_baroclinic_ms.h:228-293 with the mask
// machinery). t0, cp, im are full (nl, n, n) fields (they carry the mask and
// an x-varying S2 of a coastline configuration) and the mask an (n, n) field,
// all read per node. The boundary nodes are in the array: their neighbour
// sum is zero (relax_v pads the interior neighbour sum with zeros), so the
// kernel never reads beyond the array.
//
// Design. As K3 (mg_sweep.cu): one block owns a TY x TX tile of all nl
// layers and stages it with a two-node rim in shared memory. Blocks run in no
// order, so the red pass relaxes the red nodes of the tile and of the first
// ring around it (redundantly with the blocks that own them), a barrier, then
// the black pass relaxes the tile's black nodes, whose red neighbours are all
// current, and the tile is written to a new array. Within a pass a node reads
// only nodes of the other colour, so relaxing in place has no race. One
// thread runs a column's recurrence over nl in registers (nl is a template
// parameter). Every n >= 3 is taken, with partial tiles: the vertex levels
// are 2^k + 1 wide, so every level has one.
//
// Bound. Bytes: da, res, t0, cp, im read and da written (6 nl planes) and the
// mask (one plane); at 2049^2 x 4 in f32 419.8 MB, 0.125 ms at 3.35 TB/s.
// About 12 operations per node and layer, 3 us at 67 TFLOP/s: bytes bound
// it. The ring's red pass re-reads res and the factors of (TY + 2)(TX + 2)
// / 2 nodes from L2. The small levels (n <= 65: one to nine blocks) are bound
// by the launch.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32, TY = 32;          // nodes per block
constexpr int NTH = 256;                 // threads per block
constexpr int EW = TX + 4, EH = TY + 4;  // the tile with its 2-node rim
constexpr int ESZ = EW * EH;
constexpr int MAXNL = 8;

template <typename T>
struct Args {
  const T* da;
  const T* res;
  const T* t0;
  const T* cp;
  const T* im;
  const T* mask;
  T* out;
  int n;
  T md2;   // -d2
};

// Relax the column of the node at rim-local (ly, lx), global (gy, gx), in
// place in the staged tile `sd`.
template <typename T, int NL>
__device__ __forceinline__ void relax_node(T* sd, const Args<T>& p, int ly,
                                           int lx, int gy, int gx) {
  const int n = p.n;
  const size_t nn = (size_t)n * n, node = (size_t)gy * n + gx;
  const bool inner = gy > 0 && gy < n - 1 && gx > 0 && gx < n - 1;
  const T m = __ldg(p.mask + node);
  T* c = sd + ly * EW + lx;
  T dp[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const T* cl = c + l * ESZ;
    const T nb = inner ? ((cl[1] + cl[-1]) + cl[EW]) + cl[-EW] : T(0);
    const T rhs = (p.md2 * __ldg(p.res + l * nn + node) + nb) * m;
    const T im = __ldg(p.im + l * nn + node);
    if (l == 0)
      dp[0] = rhs * im;
    else
      dp[l] = (rhs - __ldg(p.t0 + l * nn + node) * dp[l - 1]) * im;
  }
  T x = dp[NL - 1];
  c[(NL - 1) * ESZ] = x * m;
#pragma unroll
  for (int l = NL - 2; l >= 0; --l) {
    x = dp[l] - __ldg(p.cp + l * nn + node) * x;
    c[l * ESZ] = x * m;
  }
}

// Relax the nodes of `color` in the rim-local rectangle rows [r0, r0 + nr),
// columns [c0, c0 + nc) (nc even), skipping nodes outside the array.
template <typename T, int NL>
__device__ __forceinline__ void relax_pass(T* sd, const Args<T>& p, int y0,
                                           int x0, int r0, int nr, int c0,
                                           int nc, int color) {
  const int half = nc / 2;
  for (int k = threadIdx.x; k < nr * half; k += NTH) {
    const int ly = r0 + k / half;
    const int gy = y0 - 2 + ly;
    const int gxa = x0 - 2 + c0;             // global column of the first
    const int lx = c0 + 2 * (k % half) + ((gy + gxa + color) & 1);
    const int gx = x0 - 2 + lx;
    if (gy >= 0 && gy < p.n && gx >= 0 && gx < p.n)
      relax_node<T, NL>(sd, p, ly, lx, gy, gx);
  }
}

template <typename T, int NL>
__global__ void __launch_bounds__(NTH) vsweep_kernel(const Args<T> p) {
  extern __shared__ unsigned char smem_raw[];
  T* sd = reinterpret_cast<T*>(smem_raw);   // NL planes of EH x EW
  const int n = p.n;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const size_t nn = (size_t)n * n;

  // stage the tile with its rim; nodes outside the array are never read
  for (int k = threadIdx.x; k < ESZ; k += NTH) {
    const int gy = y0 - 2 + k / EW, gx = x0 - 2 + k % EW;
    const bool in = gy >= 0 && gy < n && gx >= 0 && gx < n;
    const size_t node = in ? (size_t)gy * n + gx : 0;
#pragma unroll
    for (int l = 0; l < NL; ++l)
      sd[l * ESZ + k] = in ? __ldg(p.da + l * nn + node) : T(0);
  }
  __syncthreads();
  // red: the tile and the first ring; black: the tile
  relax_pass<T, NL>(sd, p, y0, x0, 1, TY + 2, 1, TX + 2, 0);
  __syncthreads();
  relax_pass<T, NL>(sd, p, y0, x0, 2, TY, 2, TX, 1);
  __syncthreads();
  for (int k = threadIdx.x; k < TX * TY; k += NTH) {
    const int oy = k / TX, ox = k % TX;
    const int gy = y0 + oy, gx = x0 + ox;
    if (gy < n && gx < n) {
#pragma unroll
      for (int l = 0; l < NL; ++l)
        p.out[l * nn + (size_t)gy * n + gx] =
            sd[l * ESZ + (oy + 2) * EW + ox + 2];
    }
  }
}

template <typename T, int NL>
int launch_nl(const Args<T>& p, cudaStream_t stream) {
  const size_t smem = sizeof(T) * NL * ESZ;
  if (smem > 48 * 1024) {   // more than a block gets without asking
    cudaError_t err = cudaFuncSetAttribute(
        vsweep_kernel<T, NL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int nb = (p.n + TX - 1) / TX;
  vsweep_kernel<T, NL><<<dim3(nb, nb), NTH, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* da, const void* res, const void* t0, const void* cp,
           const void* im, const void* mask, void* out, int n, int nl,
           double d2, void* stream) {
  if (n < 3 || n > 32 * 65535 || !da || !res || !t0 || !cp || !im || !mask
      || !out || da == out)
    return (int)cudaErrorInvalidValue;
  Args<T> p;
  p.da = static_cast<const T*>(da);
  p.res = static_cast<const T*>(res);
  p.t0 = static_cast<const T*>(t0);
  p.cp = static_cast<const T*>(cp);
  p.im = static_cast<const T*>(im);
  p.mask = static_cast<const T*>(mask);
  p.out = static_cast<T*>(out);
  p.n = n;
  p.md2 = T(-d2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nl) {
    case 1: return launch_nl<T, 1>(p, s);
    case 2: return launch_nl<T, 2>(p, s);
    case 3: return launch_nl<T, 3>(p, s);
    case 4: return launch_nl<T, 4>(p, s);
    case 5: return launch_nl<T, 5>(p, s);
    case 6: return launch_nl<T, 6>(p, s);
    case 7: return launch_nl<T, 7>(p, s);
    case 8: return launch_nl<T, 8>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Most layers the kernel takes.
int vmg_sweep_max_nl() { return MAXNL; }

// da, res, t0, cp, im and out (nl, n, n), mask (n, n), out another array
// than da; device pointers on `stream`. Returns the CUDA error code of the
// launch (0 on success).
int vmg_sweep_f32(const void* da, const void* res, const void* t0,
                  const void* cp, const void* im, const void* mask, void* out,
                  int n, int nl, double d2, void* stream) {
  return launch<float>(da, res, t0, cp, im, mask, out, n, nl, d2, stream);
}

int vmg_sweep_f64(const void* da, const void* res, const void* t0,
                  const void* cp, const void* im, const void* mask, void* out,
                  int n, int nl, double d2, void* stream) {
  return launch<double>(da, res, t0, cp, im, mask, out, n, nl, d2, stream);
}

const char* vmg_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
