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
// Design: a chain a column, split over lanes, fed by a TMA ring.
// - A block owns cols_for(nl) adjacent columns (8; 16 at nl = 2: 256 or
//   128 blocks at Kx = 2048, on every SM) and runs both sweeps of them in
//   one launch: the forward sweep, then the backward sweep from the last
//   row up, whose first rows of W and y are the ones the forward sweep
//   touched last. y is scratch in device memory.
// - Each column's row work is split over L = lanes_for(nl) threads of one
//   warp (the power of two at least nl): lane i owns row i of the block
//   product and its carry; the other lanes' values arrive by warp
//   shuffles. A row costs a thread nl products, and the carry's critical
//   path is one shuffle round and about nl dependent FMAs.
// - The rows arrive in stages of R = rows_for(nl, itemsize) rows, a
//   compile-time constant: a stage's rows unroll, every shared load of the
//   stage is issued before its chain, and the chain runs branch-free. R is
//   odd, and lane i reads its W planes in rotated order (plane i nl +
//   (b + i) % nl at step b), so the column's lanes hit different banks.
// - The stages form a ring of `stages` in shared memory, each with a
//   "full" and an "empty" mbarrier. Where the global strides are 16-byte
//   aligned (Kx * itemsize % 16 == 0) one extra warp's first thread fetches
//   a stage with two TMA requests: W as a 3-D tensor (Kx, N, nl^2), the
//   right-hand side as (Kx, N, nl), boxes of (cols, R, planes) that land as
//   [plane][row][column]; rows and columns past the ends arrive as zeros.
//   Elsewhere (TMA false: the same ring and arithmetic) each consumer
//   copies its own row's planes of its column with `cp.async` and arrives
//   on the full barrier as they land (`cp.async.mbarrier.arrive.noinc`);
//   only the column's lanes read them.
// - The outputs are stored as they are made (`st.global.cg`, which the
//   compiler need not order against the ring's shared loads).
// - Between the sweeps every consumer fences its y stores for the async
//   proxy; with TMA it arrives on a "turn" barrier, which the producer
//   waits on before its first backward request (that reads y).
// The launch geometry (cols, lanes, rows, stages, route, shared memory) is
// the wrapper's (solvers/fused_vary.py `geometry`); the launch refuses one
// that does not fit.
//
// Measured (tools/kv_variants.py, one H100 at 700 W, 2048^2 x 4 f32):
// 0.35 ms a solve, 0.67 of the byte bound. Without the stores 0.29 ms, the
// TMA ring alone (no arithmetic) 0.35: at 8 columns a box row is 32 bytes,
// and the ring's requests, not the chain, set the pace; 16 columns (64-byte
// rows, lanes in 2-way bank conflict) run 0.49.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int MAXNL = 8;
constexpr int MAXSTAGES = 32;
constexpr int MAXTHREADS = 384;        // consumers and the producer warp
constexpr int SMEM_LIMIT = 232448;     // dynamic shared memory a block
constexpr int MAXR = 15;               // most rows of a stage
constexpr int STAGE_BYTES = 16384;     // most bytes of a stage
constexpr int REG_WORDS = 80;          // most registers a stage preloads

// Threads a column for nl layers: the power of two at least nl.
__host__ __device__ constexpr int lanes_for(int nl) {
  return nl <= 2 ? 2 : (nl <= 4 ? 4 : 8);
}

// Columns a block: 8, 16 where a column has two lanes (so that the
// consumers are whole warps). At Kx = 2048, 256 or 128 blocks.
__host__ __device__ constexpr int cols_for(int nl) {
  return lanes_for(nl) == 2 ? 16 : 8;
}

// Rows of a stage, a compile-time constant of the kernel (a stage's rows
// unroll): the most, odd and at most MAXR, whose stage fits STAGE_BYTES
// and whose preloaded values (R (nl + 1) a thread) fit REG_WORDS
// registers. With an odd R the planes of a box are an odd multiple of 8
// words apart at 8 columns (of 16 at 16), so the column's lanes, reading
// their W planes in rotated order, hit different banks.
__host__ __device__ constexpr int rows_for(int nl, int itemsize) {
  int r = MAXR;
  while (r > 1
         && (r * cols_for(nl) * (nl * nl + nl) * itemsize > STAGE_BYTES
             || r * (nl + 1) * itemsize > 4 * REG_WORDS))
    r -= 2;
  return r;
}

__host__ __device__ constexpr int align128(int n) {
  return (n + 127) / 128 * 128;
}

// Bytes of one stage: the W box and the right-hand side box, each padded
// to 128 bytes (a TMA destination's alignment).
__host__ __device__ constexpr int stage_bytes(int nl, int itemsize, int cols,
                                              int rows) {
  return align128(rows * cols * nl * nl * itemsize)
         + align128(rows * cols * nl * itemsize);
}

// Dynamic shared memory of a launch: alignment slack, the barriers, the
// ring.
__host__ __device__ constexpr int smem_bytes(int nl, int itemsize, int cols,
                                             int rows, int stages) {
  return 128 + align128(8 * (2 * stages + 1))
         + stages * stage_bytes(nl, itemsize, cols, rows);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed. A
// wait that never ends (a fault in the pipeline) traps after about a second
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (tries == (1u << 24)) __trap();
  }
}

// TMA: the box of `map` at (c0, c1, c2) into shared memory at dst,
// completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_u32(smem)), "l"(gmem) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(smem_u32(smem)), "l"(gmem) : "memory");
}

// The barrier's pending arrival of this thread completes when all of its
// earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

struct Maps {
  CUtensorMap w, x, y;    // W, and the right-hand sides X and Y
};

template <typename T>
struct Args {
  const T* W;
  const T* X;
  T* Y;
  T* Psi;
  T a;
  int N, K, stages;
};

// The R rows of one stage of column c, in sweep order. `w` and `x` are
// the stage's W and right-hand side boxes. Lane i < nl of the
// column owns row i of the block product and its carry (lanes past nl
// compute row 0's and store nothing): it loads its W plane row and
// right-hand side value of every row of the stage first, then runs the
// chain branch-free, taking the other lanes' values by shuffles. Rows
// past the sweep's end (j0 + r outside 0..N-1) come after its last row,
// so computing them spoils only a carry that the next sweep resets; their
// stores are skipped.
template <typename T, int NL, int R, bool BWD>
__device__ __forceinline__ void stage_rows(
    const T* __restrict__ w, const T* __restrict__ x, int c, int lane,
    int src0, T a, T& carry, T* __restrict__ out, size_t NK, int K,
    bool live, int j0, int N) {
  constexpr int C = cols_for(NL);
  static_assert(lanes_for(NL) >= NL, "one row of the block product a lane");
  // the element of plane p, row r of a box
  auto at = [&](const T* box, int p, int r) {
    return box[(p * R + r) * C + c];
  };
  const int i = lane < NL ? lane : 0;
  // the plane, and the lane whose value it multiplies, of step bb
  int src[NL];
  T wv[R][NL], xv[R];
#pragma unroll
  for (int bb = 0; bb < NL; ++bb) src[bb] = (bb + i) % NL;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int bb = 0; bb < NL; ++bb) wv[r][bb] = at(w, i * NL + src[bb], r);
    xv[r] = at(x, i, r);
  }
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const int r = BWD ? R - 1 - rr : rr;
    const int j = j0 + r;
    // forward: y_i = sum_b W_ib (x_b - a y_b'), the lanes' x_b - a y_b'
    // shuffled; backward: psi_i = y_i - a sum_b W_ib psi_b'
    const T v = BWD ? carry : xv[r] - a * carry;
    T acc = T(0);
#pragma unroll
    for (int bb = 0; bb < NL; ++bb)
      acc += wv[r][bb] * __shfl_sync(0xffffffffu, v, src0 + src[bb]);
    carry = BWD ? xv[r] - a * acc : acc;
    if (live && lane < NL && j >= 0 && j < N)
      __stcg(out + lane * NK + (size_t)j * K, carry);
  }
}

// Both sweeps of `cols` columns a block, stages of R rows: stages 0..G-1
// forward, G..2G-1 backward. TMA: the last warp's first thread produces;
// else each consumer copies its own rows' W planes and right-hand side
// plane of its column.
template <typename T, int NL, bool TMA>
__global__ void __launch_bounds__(MAXTHREADS)
    sweep_kernel(const __grid_constant__ Maps maps, const Args<T> p) {
  constexpr int L = lanes_for(NL);
  constexpr int NB = NL * NL;
  constexpr int IS = (int)sizeof(T);
  constexpr int R = rows_for(NL, IS);
  constexpr int COLS = cols_for(NL);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + p.stages;
  uint64_t* turn = empty + p.stages;
  unsigned char* ring = base + align128(8 * (2 * p.stages + 1));
  constexpr int wbytes = align128(R * COLS * NB * IS);
  constexpr int sbytes = stage_bytes(NL, IS, COLS, R);
  constexpr int consumers = COLS * L;
  const int G = (p.N + R - 1) / R;             // stages a sweep
  const int k0 = blockIdx.x * COLS;
  const size_t NK = (size_t)p.N * p.K;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], TMA ? 1 : consumers);
      mbar_init(&empty[s], consumers);
    }
    mbar_init(turn, consumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= consumers) {   // the producer warp
    if (!TMA || threadIdx.x != consumers) return;
    for (int g = 0; g < 2 * G; ++g) {
      const int s = g % p.stages, u = g / p.stages;
      if (u > 0) mbar_wait(&empty[s], (u - 1) & 1);
      if (g == G) mbar_wait(turn, 0);   // y is written
      const bool bwd = g >= G;
      const int j0 = bwd ? p.N - (g - G + 1) * R : g * R;
      unsigned char* st = ring + (size_t)s * sbytes;
      mbar_expect_tx(&full[s], (uint32_t)(R * COLS * (NB + NL) * IS));
      tma_load(st, &maps.w, &full[s], k0, j0, 0);
      tma_load(st + wbytes, bwd ? &maps.y : &maps.x, &full[s], k0, j0, 0);
    }
    return;
  }

  // consumers: thread t is lane t % L of column t / L
  const int t = threadIdx.x;
  const int c = t / L, lane = t % L;
  const int src0 = (t & 31) & ~(L - 1);        // lane 0 of the column
  const int k = k0 + c;
  const bool live = k < p.K;

  // element copies (TMA false) of this thread's part of stage g: the W
  // planes of its row and its right-hand side plane; the column's lanes
  // alone read them, so a __syncwarp before the copies frees the slot
  auto copy_stage = [&](int g) {
    const int s = g % p.stages;
    const bool bwd = g >= G;
    const int j0 = bwd ? p.N - (g - G + 1) * R : g * R;
    T* sw = reinterpret_cast<T*>(ring + (size_t)s * sbytes);
    T* sx = reinterpret_cast<T*>(ring + (size_t)s * sbytes + wbytes);
    const T* rhs = bwd ? p.Y : p.X;
    // the element of plane q, row r of a box, where TMA would put it
    auto at = [&](T* box, int q, int r) {
      return box + (q * R + r) * COLS + c;
    };
    if (live && lane < NL) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = j0 + r;
        if (j < 0 || j >= p.N) continue;
        const size_t off = (size_t)j * p.K + k;
#pragma unroll
        for (int b = 0; b < NL; ++b)
          cp_async(at(sw, lane * NL + b, r), p.W + (lane * NL + b) * NK + off);
        cp_async(at(sx, lane, r), rhs + lane * NK + off);
      }
    }
    cp_async_arrive(&full[s]);
  };
  // the copy route issues stage g + stages - 1 at stage g, a backward
  // stage not before the turn (it reads y)
  if constexpr (!TMA) {
    for (int g = 0; g < p.stages - 1 && g < G; ++g) copy_stage(g);
  }

  T carry = T(0);
  for (int g = 0; g < 2 * G; ++g) {
    const bool bwd = g >= G;
    if (g == G) {
      // the forward sweep's y stores, before the backward's reads
      __threadfence();
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
      if constexpr (TMA) {
        mbar_arrive(turn);
      } else {
        for (int q = G; q < G + p.stages - 1 && q < 2 * G; ++q)
          copy_stage(q);
      }
      carry = T(0);
    }
    if constexpr (!TMA) {
      const int q = g + p.stages - 1;
      __syncwarp();
      if (q < 2 * G && (q < G || bwd)) copy_stage(q);
    }
    const int s = g % p.stages, u = g / p.stages;
    mbar_wait(&full[s], u & 1);
    const T* sw = reinterpret_cast<const T*>(ring + (size_t)s * sbytes);
    const T* sx = reinterpret_cast<const T*>(ring + (size_t)s * sbytes
                                             + wbytes);
    const int j0 = bwd ? p.N - (g - G + 1) * R : g * R;
    if (bwd)
      stage_rows<T, NL, R, true>(sw, sx, c, lane, src0, p.a, carry,
                                 p.Psi + k, NK, p.K, live, j0, p.N);
    else
      stage_rows<T, NL, R, false>(sw, sx, c, lane, src0, p.a, carry,
                                  p.Y + k, NK, p.K, live, j0, p.N);
    if constexpr (TMA) mbar_arrive(&empty[s]);
  }
  if constexpr (!TMA) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime, so
// that the library links without -lcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess
        || q != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) != cudaSuccess)
      return nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// `planes` contiguous (N, K) planes, read in (cols, rows, planes) boxes.
template <typename T>
bool make_map(EncodeTiled enc, CUtensorMap* map, const T* ptr, int N, int K,
              int planes, int cols, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)N,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)K * sizeof(T),
                                 (cuuint64_t)N * K * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows,
                             (cuuint32_t)planes};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
             3, const_cast<T*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int NL, bool TMA>
int launch_route(const Maps& maps, const Args<T>& args, int threads,
                 int smem, cudaStream_t s) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        sweep_kernel<T, NL, TMA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const dim3 grid((args.K + cols_for(NL) - 1) / cols_for(NL));
  sweep_kernel<T, NL, TMA><<<grid, threads, smem, s>>>(maps, args);
  return (int)cudaGetLastError();
}

template <typename T, int NL>
int launch_nl(const Maps& maps, const Args<T>& args, int tma, int threads,
              int smem, cudaStream_t s) {
  return tma ? launch_route<T, NL, true>(maps, args, threads, smem, s)
             : launch_route<T, NL, false>(maps, args, threads, smem, s);
}

// The launch for the wrapper's geometry, or cudaErrorInvalidValue for a
// geometry or arguments that do not fit.
template <typename T>
int launch(const void* W, const void* X, void* Y, void* Psi, int nl, int N,
           int K, double a, int cols, int lanes, int rows, int stages,
           int tma, int smem, void* stream) {
  constexpr int IS = (int)sizeof(T);
  if (N < 1 || K < 1 || !W || !X || !Y || !Psi || Y == X || Psi == Y
      || nl < 2 || nl > MAXNL || lanes != lanes_for(nl)
      || cols != cols_for(nl) || (cols * lanes) % 32 != 0
      || cols * lanes + 32 > MAXTHREADS || rows != rows_for(nl, IS)
      || stages < 1
      || stages > MAXSTAGES || (tma != 0 && tma != 1)
      || smem != smem_bytes(nl, IS, cols, rows, stages)
      || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  Maps maps = {};
  if (tma) {
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(W)
                           | reinterpret_cast<uintptr_t>(X)
                           | reinterpret_cast<uintptr_t>(Y);
    if ((size_t)K * IS % 16 != 0 || cols * IS % 16 != 0 || ptrs % 16 != 0)
      return (int)cudaErrorInvalidValue;
    const EncodeTiled enc = encoder();
    if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
    if (!make_map(enc, &maps.w, static_cast<const T*>(W), N, K, nl * nl,
                  cols, rows)
        || !make_map(enc, &maps.x, static_cast<const T*>(X), N, K, nl, cols,
                     rows)
        || !make_map(enc, &maps.y, static_cast<const T*>(Y), N, K, nl, cols,
                     rows))
      return (int)cudaErrorInvalidValue;
  }
  Args<T> args;
  args.W = static_cast<const T*>(W);
  args.X = static_cast<const T*>(X);
  args.Y = static_cast<T*>(Y);
  args.Psi = static_cast<T*>(Psi);
  args.a = T(a);
  args.N = N;
  args.K = K;
  args.stages = stages;
  const int threads = cols * lanes + 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nl) {
    case 2: return launch_nl<T, 2>(maps, args, tma, threads, smem, s);
    case 3: return launch_nl<T, 3>(maps, args, tma, threads, smem, s);
    case 4: return launch_nl<T, 4>(maps, args, tma, threads, smem, s);
    case 5: return launch_nl<T, 5>(maps, args, tma, threads, smem, s);
    case 6: return launch_nl<T, 6>(maps, args, tma, threads, smem, s);
    case 7: return launch_nl<T, 7>(maps, args, tma, threads, smem, s);
    default: return launch_nl<T, 8>(maps, args, tma, threads, smem, s);
  }
}

}  // namespace

extern "C" {

// Most layers the kernel takes (at least 2).
int vary_sweep_max_nl() { return MAXNL; }

// W (nl, nl, N, K), X, Y, Psi (nl, N, K), contiguous device arrays; Y is
// scratch (the forward sweep's output), Psi the result. The geometry is
// solvers/fused_vary.py's `geometry`: `cols` columns a block, `lanes`
// threads a column, a ring of `stages` stages of `rows` rows, TMA boxes
// (tma = 1) or element copies (0), `smem` bytes of dynamic shared memory.
// Launches both sweeps on `stream`; returns the CUDA error code (0 on
// success, cudaErrorInvalidValue for a geometry that does not fit).
int vary_sweep_f32(const void* W, const void* X, void* Y, void* Psi, int nl,
                   int N, int K, double a, int cols, int lanes, int rows,
                   int stages, int tma, int smem, void* stream) {
  return launch<float>(W, X, Y, Psi, nl, N, K, a, cols, lanes, rows, stages,
                       tma, smem, stream);
}

int vary_sweep_f64(const void* W, const void* X, void* Y, void* Psi, int nl,
                   int N, int K, double a, int cols, int lanes, int rows,
                   int stages, int tma, int smem, void* stream) {
  return launch<double>(W, X, Y, Psi, nl, N, K, a, cols, lanes, rows, stages,
                        tma, smem, stream);
}

const char* vary_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
