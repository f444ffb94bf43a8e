// Red-black vertical-line relaxation sweep for Hopper (sm_90a): kernel K3 of
// the port.
//
// Replaces the Pallas TPU kernel `_sweep_kernel`
// (msom_tpu/solvers/pallas_mg.py, entry `rb_line_sweep`) on walled levels
// whose coefficients are y-profiles. One launch is one full sweep of the
// layered multigrid's smoother: for the red cells ((row + column) even), then
// for the black cells on the result of the red pass, per cell
//
//   rhs[l] = -d2 * res[l] + (E + W + N + S of da[l])
//   dp[0]  = rhs[0] * im[0];  dp[l] = (rhs[l] - t0[l] * dp[l-1]) * im[l]
//   x[nl-1] = dp[nl-1];       x[l]  = dp[l] - cp[l] * x[l+1]
//
// the exact solve of the column's vertical tridiagonal system with the
// horizontal neighbours frozen (poisson_layer.h:48-150). t0, cp, im are the
// (nl, n) y-profiles of the Thomas factors, read per row. A neighbour beyond
// a wall is the ghost sign * (current value of the edge cell itself),
// Dirichlet -1 / Neumann +1, so an edge cell's own old value enters its own
// right-hand side; it is evaluated when the cell is relaxed, hence anew for
// each colour.
//
// Design. One block owns a TY x TX tile of all nl layers and stages it with a
// two-cell rim in shared memory. Blocks run in no order, so nothing a
// neighbouring block computes can be read: the red pass relaxes the red cells
// of the tile and of the first ring around it (redundantly with the blocks
// that own them), a barrier, then the black pass relaxes the tile's black
// cells, whose red neighbours are now all current, and the tile is written.
// Ring cells outside the domain are never relaxed. Within a pass a cell reads
// only cells of the other colour (and itself), so relaxing in place in shared
// memory has no race. One thread runs a column's recurrence over nl in
// registers (nl is a template parameter). The output is a new array: the rim
// reads the input of other blocks' tiles.
//
// Bound. Bytes: da and res read, da written, 3 * nl * n^2 values; at
// 2048^2 x 4 in f32 201 MB, 0.060 ms at 3.35 TB/s. About 10 operations per
// cell and layer, 2.5 us at 67 TFLOP/s: bytes bound it. The small levels of a
// V-cycle (n <= 64: one to four blocks) are bound by the launch instead.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32, TY = 32;          // cells per block
constexpr int NTH = 256;                 // threads per block
constexpr int EW = TX + 4, EH = TY + 4;  // the tile with its 2-cell rim
constexpr int ESZ = EW * EH;
constexpr int MAXNL = 8;

template <typename T>
struct Args {
  const T* da;
  const T* res;
  const T* t0;
  const T* cp;
  const T* im;
  T* out;
  int n;
  T md2, sign_x, sign_y;   // md2 = -d2
};

// Relax the column of the cell at rim-local (ly, lx), global (gy, gx), in
// place in the staged tile `sd`.
template <typename T, int NL>
__device__ __forceinline__ void relax_cell(T* sd, const Args<T>& p, int ly,
                                           int lx, int gy, int gx) {
  const int n = p.n;
  const size_t nn = (size_t)n * n, cell = (size_t)gy * n + gx;
  T* c = sd + ly * EW + lx;
  T dp[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const T* cl = c + l * ESZ;
    const T self = cl[0];
    const T e = gx + 1 < n ? cl[1] : p.sign_x * self;
    const T w = gx > 0 ? cl[-1] : p.sign_x * self;
    const T no = gy + 1 < n ? cl[EW] : p.sign_y * self;
    const T so = gy > 0 ? cl[-EW] : p.sign_y * self;
    const T rhs = p.md2 * __ldg(p.res + l * nn + cell) + (((e + w) + no) + so);
    const T im = __ldg(p.im + l * n + gy);
    if (l == 0)
      dp[0] = rhs * im;
    else
      dp[l] = (rhs - __ldg(p.t0 + l * n + gy) * dp[l - 1]) * im;
  }
  T x = dp[NL - 1];
  c[(NL - 1) * ESZ] = x;
#pragma unroll
  for (int l = NL - 2; l >= 0; --l) {
    x = dp[l] - __ldg(p.cp + l * n + gy) * x;
    c[l * ESZ] = x;
  }
}

// Relax the cells of `color` in the rim-local rectangle rows [r0, r0 + nr),
// columns [c0, c0 + nc) (nc even), skipping cells outside the domain.
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
      relax_cell<T, NL>(sd, p, ly, lx, gy, gx);
  }
}

template <typename T, int NL>
__global__ void __launch_bounds__(NTH) sweep_kernel(const Args<T> p) {
  extern __shared__ unsigned char smem_raw[];
  T* sd = reinterpret_cast<T*>(smem_raw);   // NL planes of EH x EW
  const int n = p.n;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const size_t nn = (size_t)n * n;

  // stage the tile with its rim; cells outside the domain are never read
  // (a wall neighbour is the ghost of the cell itself)
  for (int k = threadIdx.x; k < ESZ; k += NTH) {
    const int gy = y0 - 2 + k / EW, gx = x0 - 2 + k % EW;
    const bool in = gy >= 0 && gy < n && gx >= 0 && gx < n;
    const size_t cell = in ? (size_t)gy * n + gx : 0;
#pragma unroll
    for (int l = 0; l < NL; ++l)
      sd[l * ESZ + k] = in ? __ldg(p.da + l * nn + cell) : T(0);
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
        sweep_kernel<T, NL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int nb = (p.n + TX - 1) / TX;
  sweep_kernel<T, NL><<<dim3(nb, nb), NTH, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* da, const void* res, const void* t0, const void* cp,
           const void* im, void* out, int n, int nl, double d2, double sign_x,
           double sign_y, void* stream) {
  if (n < 1 || n > 32 * 65535 || !da || !res || !t0 || !cp || !im || !out
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
  p.md2 = T(-d2);
  p.sign_x = T(sign_x);
  p.sign_y = T(sign_y);
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
int mg_sweep_max_nl() { return MAXNL; }

// da, res and out (nl, n, n), out another array than da; t0, cp, im (nl, n);
// device pointers on `stream`. Returns the CUDA error code of the launch (0
// on success).
int mg_sweep_f32(const void* da, const void* res, const void* t0,
                 const void* cp, const void* im, void* out, int n, int nl,
                 double d2, double sign_x, double sign_y, void* stream) {
  return launch<float>(da, res, t0, cp, im, out, n, nl, d2, sign_x, sign_y,
                       stream);
}

int mg_sweep_f64(const void* da, const void* res, const void* t0,
                 const void* cp, const void* im, void* out, int n, int nl,
                 double d2, double sign_x, double sign_y, void* stream) {
  return launch<double>(da, res, t0, cp, im, out, n, nl, d2, sign_x, sign_y,
                        stream);
}

const char* mg_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
