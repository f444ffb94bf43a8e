// Fused qg-node tendency on the vertex grid for Hopper (sm_90a): kernel K5 of
// the port.
//
// Replaces the Pallas TPU kernel `_node_kernel`
// (msom_tpu/models/pallas_node_rhs.py, entry `rhs_fused_node`). From psi
// (nl, M, M) on the M = N+1 vertices, the interior mask (M, M) and the static
// fields it computes, in one pass over device memory, the walled rhs_pv
// (qg_baroclinic_ms.h:103-196; models/qg_node.py):
//
//   p      = psi * mask
//   zeta   = lap p on the interior nodes; on the ring the partial-slip rule
//            c2 * p(first interior node), corners 0            (bc_deriv)
//   dq     = -J(p, zeta) - beta (pE - pW) / (2 delta)
//            - J(pp, zeta)                                      (with pp)
//            - s_l(y) idh1[l] Jd_l + s_l-1(y) idh0[l] Jd_l-1
//               Jd_l = J(p_l, p_l+1) + J(pp_l, p_l+1) + J(p_l, pp_l+1)
//            - fric zeta - J(p, topo) topo_fac    (bottom layer; topo opt.)
//            + nu (Gamma(zeta) + tmp),  tmp = lap zeta on the interior, on
//               the ring c2 * (zeta(first interior) - zeta(ring))
//                                                              (bc_deriv_rel)
//            - nu4 (Gamma(tmp) + lap tmp)
//            + wind(y) (layer 0) + qf3                          (qf3 opt.)
//   dq    *= mask
//
// where J(a, b) is qg-node's +J Arakawa bracket (the msqg -J bracket with
// its arguments swapped), zero on the ring, as are lap and beta, and Gamma
// the vertical stretching with the (nl-1, M) y-profile s. At nl = 1 it is
// rhs_pv_barotropic (qg_barotropic.h:16-29): dq = (-J(psi, q) - beta term
// - fric q + wind + nu lap q) * mask, with neither psi nor q masked.
//
// Design. One block computes a TY x TX tile of outputs for all nl layers
// (nl a template parameter, 2 to 8). M = N+1 is odd, so rows are not 16-byte
// aligned and the last tile is partial: every staging loop tests the global
// index itself and nodes outside the array are zero (they never feed an
// output). p is staged in shared memory with a 3-node halo, zeta on a 2-node
// halo, tmp on a 1-node halo, each after a barrier, because a ring rule reads
// its parent's interior (zeta's ring from p, tmp's ring from zeta's interior
// and zeta's own ring): with the halos staged in that order every ring value
// a stage reads exists. The ring is global row and column 0 and M-1. The
// J-terms are evaluated at interior nodes only, whose eight neighbours are
// all inside the array, so pp and topo are read straight from device memory.
// Each thread owns TY/BY output rows of one column and walks the layers in
// order, carrying the interface Jacobian Jd_l to layer l+1 in a register.
// The wrapper refuses an nl and type whose planes exceed the 227 KB of
// shared memory a block may use (f64 at nl = 8). The barotropic kernel
// stages nothing: one thread a node, neighbours from device memory.
//
// Bound. At 2048^2 x 4 in f32 (no pp, topo or qf3) the compulsory traffic is
// psi and the mask in and dq out, 9 * 2049^2 * 4 B = 151 MB, 45 us at
// 3.35 TB/s; about 90 FP32 operations per node and layer (fused_node_rhs.
// bound_work counts them), 23 us at 67 TFLOP/s: bytes bound it.
// This version recomputes the halo rings (zeta on (TY+4)(TX+4), tmp on
// (TY+2)(TX+2) nodes per TY*TX outputs) and is written to be right first.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32, TY = 32;          // outputs per block
constexpr int BX = 32, BY = 8;           // threads per block
constexpr int RPT = TY / BY;             // output rows per thread
constexpr int NTH = BX * BY;
constexpr int MAXNL = 8;
constexpr int PW = TX + 6, PH = TY + 6;  // p = psi * mask, 3-node halo
constexpr int ZW = TX + 4, ZH = TY + 4;  // zeta, 2-node halo
constexpr int MW = TX + 2, MH = TY + 2;  // tmp, 1-node halo
constexpr int PSZ = PW * PH, ZSZ = ZW * ZH, MSZ = MW * MH;

// Order of the device pointers handed to the C entry points.
enum Ptr { PSI, MASK, WIND, S2, DQ, Q, PP, TOPO, QF3, NPTRS };

struct Params {
  int M;
  double delta, beta, nu, nu4, fric, topo_fac, c2;
  double idh0[MAXNL], idh1[MAXNL];
};

template <typename T>
struct Fields {
  const T *psi, *mask, *wind, *s2, *q, *pp, *topo, *qf3;
  T* dq;
};

size_t smem_bytes(int nl, int itemsize) {
  return nl < 2 ? 0 : (size_t)itemsize * nl * (PSZ + ZSZ + MSZ);
}

// The eight neighbours of a node.
template <typename T>
struct Nb {
  T e, w, n, s, ne, nw, se, sw;
};

// Neighbours of the node p points at in a plane of row stride wp (shared or
// device memory).
template <typename T>
__device__ __forceinline__ Nb<T> nb_at(const T* p, int wp) {
  return {p[1],      p[-1],     p[wp],      p[-wp],
          p[wp + 1], p[wp - 1], p[-wp + 1], p[-wp - 1]};
}

// The msqg -J(p, q) 12-point Arakawa bracket (ops/ghost.arakawa_mjac_g);
// qg-node's +J(a, b) is mjac(b, a).
template <typename T>
__device__ __forceinline__ T mjac(const Nb<T>& p, const Nb<T>& q, T i12d2) {
  const T j = (q.e - q.w) * (p.n - p.s) + (q.s - q.n) * (p.e - p.w)
            + q.e * (p.ne - p.se) - q.w * (p.nw - p.sw)
            - q.n * (p.ne - p.nw) + q.s * (p.se - p.sw)
            + p.n * (q.ne - q.nw) - p.s * (q.se - q.sw)
            - p.e * (q.ne - q.se) + p.w * (q.nw - q.sw);
  return j * i12d2;
}

template <typename T>
__device__ __forceinline__ T lap5(const T* f, int w, T id2) {
  return ((((f[1] + f[-1]) + f[w]) + f[-w]) - T(4) * f[0]) * id2;
}

// Gamma(a)[l] at one node: a points at layer l's node, layers `plane` apart;
// s is the (nl-1, M) profile.
template <typename T, int NL>
__device__ __forceinline__ T gamma_at(const T* a, int plane, int l,
                                      const T* __restrict__ s, int M, int gy,
                                      const Params& p) {
  T g = T(0);
  if (l > 0) g = s[(l - 1) * M + gy] * (a[-plane] - a[0]) * T(p.idh0[l]);
  if (l < NL - 1) g -= s[l * M + gy] * (a[0] - a[plane]) * T(p.idh1[l]);
  return g;
}

__device__ __forceinline__ bool inside(int g, int M) {
  return g >= 0 && g < M;
}

__device__ __forceinline__ bool inner(int g, int M) {
  return g >= 1 && g <= M - 2;
}

// The (dy, dx) step from a non-corner ring node to its first interior node;
// false for a corner or a node off the ring.
__device__ __forceinline__ bool ring_step(int gy, int gx, int M, int& dy,
                                          int& dx) {
  const bool ry = gy == 0 || gy == M - 1, rx = gx == 0 || gx == M - 1;
  if (ry == rx) return false;   // interior node, or a corner
  dy = ry ? (gy == 0 ? 1 : -1) : 0;
  dx = rx ? (gx == 0 ? 1 : -1) : 0;
  return true;
}

// The layered tendency, nl = NL >= 2. COUPLED = false compiles out pp, topo
// and qf3 (the uncoupled launch keeps its registers); COUPLED = true takes
// them from the non-null pointers of F.
template <typename T, int NL, bool COUPLED>
__global__ void __launch_bounds__(NTH)
node_kernel(const Fields<T> F, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const int M = p.M;
  T* sp = reinterpret_cast<T*>(smem_raw);  // p     (NL, PH, PW)
  T* sz = sp + NL * PSZ;                   // zeta  (NL, ZH, ZW)
  T* sm = sz + NL * ZSZ;                   // tmp   (NL, MH, MW)
  const bool has_pg = COUPLED && F.pp != nullptr;
  const bool has_topo = COUPLED && F.topo != nullptr;
  const bool has_qf3 = COUPLED && F.qf3 != nullptr;

  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * BX + threadIdx.x;
  const size_t MM = (size_t)M * M;
  const T id2 = T(1.0 / (p.delta * p.delta));
  const T i12d2 = T(1.0 / (12.0 * p.delta * p.delta));
  const T i2d = T(1.0 / (2.0 * p.delta));
  const T c2 = T(p.c2);

  // 1. p = psi * mask on a 3-node halo, zero outside the array
  for (int k = tid; k < NL * PSZ; k += NTH) {
    const int l = k / PSZ, r = k % PSZ;
    const int gy = y0 - 3 + r / PW, gx = x0 - 3 + r % PW;
    T v = T(0);
    if (inside(gy, M) && inside(gx, M)) {
      const size_t node = (size_t)gy * M + gx;
      v = F.psi[l * MM + node] * F.mask[node];
    }
    sp[k] = v;
  }
  __syncthreads();

  // 2. zeta on a 2-node halo: the Laplacian inside, the ring rule from p
  for (int k = tid; k < NL * ZSZ; k += NTH) {
    const int l = k / ZSZ, r = k % ZSZ, iy = r / ZW, ix = r % ZW;
    const int gy = y0 - 2 + iy, gx = x0 - 2 + ix;
    const T* c = sp + l * PSZ + (iy + 1) * PW + ix + 1;
    T v = T(0);
    int dy, dx;
    if (inner(gy, M) && inner(gx, M))
      v = lap5(c, PW, id2);
    else if (inside(gy, M) && inside(gx, M) && ring_step(gy, gx, M, dy, dx))
      v = c2 * c[dy * PW + dx];
    sz[k] = v;
  }
  __syncthreads();

  // 3. tmp on a 1-node halo: the Laplacian of zeta inside, the ring rule
  //    from zeta's first interior node less zeta's own ring value
  for (int k = tid; k < NL * MSZ; k += NTH) {
    const int l = k / MSZ, r = k % MSZ, iy = r / MW, ix = r % MW;
    const int gy = y0 - 1 + iy, gx = x0 - 1 + ix;
    const T* c = sz + l * ZSZ + (iy + 1) * ZW + ix + 1;
    T v = T(0);
    int dy, dx;
    if (inner(gy, M) && inner(gx, M))
      v = lap5(c, ZW, id2);
    else if (inside(gy, M) && inside(gx, M) && ring_step(gy, gx, M, dy, dx))
      v = c2 * (c[dy * ZW + dx] - c[0]);
    sm[k] = v;
  }
  __syncthreads();

  // 4. the tendency at the outputs, layer by layer
  const int ox = threadIdx.x, gx = x0 + ox;
  T jprev[RPT];   // the interface Jacobian Jd_l-1 at this thread's nodes
#pragma unroll
  for (int j = 0; j < RPT; ++j) jprev[j] = T(0);

#pragma unroll 1
  for (int l = 0; l < NL; ++l) {
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int oy = threadIdx.y + BY * j, gy = y0 + oy;
      if (gy >= M || gx >= M) continue;
      const size_t node = (size_t)gy * M + gx;
      const T* P = sp + l * PSZ + (oy + 3) * PW + ox + 3;
      const T* Z = sz + l * ZSZ + (oy + 2) * ZW + ox + 2;
      const T* Tm = sm + l * MSZ + (oy + 1) * MW + ox + 1;
      const bool in = inner(gy, M) && inner(gx, M);
      T acc = T(0);
      if (in) {
        const Nb<T> pn = nb_at(P, PW), zn = nb_at(Z, ZW);
        acc = -mjac(zn, pn, i12d2);
        Nb<T> ppn;
        if (has_pg) {
          ppn = nb_at(F.pp + l * MM + node, M);
          acc -= mjac(zn, ppn, i12d2);
        }
        acc -= T(p.beta) * (pn.e - pn.w) * i2d;
        T jnext = T(0);
        if (l < NL - 1) {
          const Nb<T> pup = nb_at(P + PSZ, PW);
          jnext = mjac(pup, pn, i12d2);
          if (has_pg)
            jnext += mjac(pup, ppn, i12d2)
                   + mjac(nb_at(F.pp + (l + 1) * MM + node, M), pn, i12d2);
          acc -= F.s2[l * M + gy] * jnext * T(p.idh1[l]);
        }
        if (l > 0) acc += F.s2[(l - 1) * M + gy] * jprev[j] * T(p.idh0[l]);
        jprev[j] = jnext;
        if (has_topo && l == NL - 1)
          acc -= mjac(nb_at(F.topo + node, M), pn, i12d2) * T(p.topo_fac);
      }
      if (l == NL - 1) acc -= T(p.fric) * Z[0];
      if (p.nu != 0.0) {
        acc += T(p.nu) * gamma_at<T, NL>(Z, ZSZ, l, F.s2, M, gy, p);
        acc += T(p.nu) * Tm[0];
      }
      if (p.nu4 != 0.0) {
        T bih = gamma_at<T, NL>(Tm, MSZ, l, F.s2, M, gy, p);
        if (in) bih += lap5(Tm, MW, id2);
        acc -= T(p.nu4) * bih;
      }
      if (l == 0) acc += F.wind[gy];
      if (has_qf3) acc += F.qf3[l * MM + node];
      F.dq[l * MM + node] = acc * F.mask[node];
    }
  }
}

// The barotropic tendency, nl = 1: one thread a node.
template <typename T>
__global__ void __launch_bounds__(NTH)
baro_kernel(const Fields<T> F, const Params p) {
  const int M = p.M;
  const int gx = blockIdx.x * BX + threadIdx.x;
  const int gy = blockIdx.y * BY + threadIdx.y;
  if (gy >= M || gx >= M) return;
  const size_t node = (size_t)gy * M + gx;
  const T* Q = F.q + node;
  T acc = T(0);
  const bool in = inner(gy, M) && inner(gx, M);
  if (in) {
    const Nb<T> pn = nb_at(F.psi + node, M);
    acc = -mjac(nb_at(Q, M), pn, T(1.0 / (12.0 * p.delta * p.delta)))
        - T(p.beta) * (pn.e - pn.w) * T(1.0 / (2.0 * p.delta));
  }
  acc -= T(p.fric) * Q[0];
  acc += F.wind[gy];
  if (in && p.nu != 0.0)
    acc += T(p.nu) * lap5(Q, M, T(1.0 / (p.delta * p.delta)));
  F.dq[node] = acc * F.mask[node];
}

template <typename T, int NL>
int run_nl(const Fields<T>& F, const Params& p, cudaStream_t stream) {
  const bool coupled = F.pp || F.topo || F.qf3;
  void (*kernel)(const Fields<T>, const Params) =
      coupled ? node_kernel<T, NL, true> : node_kernel<T, NL, false>;
  const size_t smem = smem_bytes(NL, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.M + TX - 1) / TX, (p.M + TY - 1) / TY), block(BX, BY);
  kernel<<<grid, block, smem, stream>>>(F, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* const* ptrs, int M, int nl, const double* scal,
           const double* idh0, const double* idh1, void* stream) {
  if (nl < 1 || nl > MAXNL || M < 3) return (int)cudaErrorInvalidValue;
  if (!ptrs[PSI] || !ptrs[MASK] || !ptrs[WIND] || !ptrs[DQ]
      || (nl > 1 && !ptrs[S2]) || (nl == 1 && !ptrs[Q]))
    return (int)cudaErrorInvalidValue;
  Fields<T> F;
  F.psi = static_cast<const T*>(ptrs[PSI]);
  F.mask = static_cast<const T*>(ptrs[MASK]);
  F.wind = static_cast<const T*>(ptrs[WIND]);
  F.s2 = static_cast<const T*>(ptrs[S2]);
  F.q = static_cast<const T*>(ptrs[Q]);
  F.pp = static_cast<const T*>(ptrs[PP]);
  F.topo = static_cast<const T*>(ptrs[TOPO]);
  F.qf3 = static_cast<const T*>(ptrs[QF3]);
  F.dq = static_cast<T*>(const_cast<void*>(ptrs[DQ]));
  Params p;
  p.M = M;
  p.delta = scal[0];
  p.beta = scal[1];
  p.nu = scal[2];
  p.nu4 = scal[3];
  p.fric = scal[4];
  p.topo_fac = scal[5];
  p.c2 = scal[6];
  for (int l = 0; l < MAXNL; ++l) {
    p.idh0[l] = l < nl ? idh0[l] : 0.0;
    p.idh1[l] = l < nl ? idh1[l] : 0.0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nl) {
    case 1: {
      const dim3 grid((M + BX - 1) / BX, (M + BY - 1) / BY), block(BX, BY);
      baro_kernel<T><<<grid, block, 0, s>>>(F, p);
      return (int)cudaGetLastError();
    }
    case 2: return run_nl<T, 2>(F, p, s);
    case 3: return run_nl<T, 3>(F, p, s);
    case 4: return run_nl<T, 4>(F, p, s);
    case 5: return run_nl<T, 5>(F, p, s);
    case 6: return run_nl<T, 6>(F, p, s);
    case 7: return run_nl<T, 7>(F, p, s);
    case 8: return run_nl<T, 8>(F, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Most layers the kernel takes.
int node_rhs_max_nl() { return MAXNL; }

// Dynamic shared memory of one block, in bytes.
long long node_rhs_smem_bytes(int nl, int itemsize) {
  return (long long)smem_bytes(nl, itemsize);
}

// ptrs = device pointers in the order of `Ptr` (psi, mask, wind, s2, dq, q,
// pp, topo, qf3), null where a field is absent: s2 the (nl-1, M) profile
// (nl > 1), q the PV (nl = 1 only), pp, topo and qf3 the optional fields
// (nl > 1). scal = {delta, beta, nu, nu4, fric, topo_fac, c2}; idh0/idh1
// host arrays of nl doubles. Launches on `stream` and returns the CUDA
// error code of the launch (0 on success).
int node_rhs_f32(const void* const* ptrs, int M, int nl, const double* scal,
                 const double* idh0, const double* idh1, void* stream) {
  return launch<float>(ptrs, M, nl, scal, idh0, idh1, stream);
}

int node_rhs_f64(const void* const* ptrs, int M, int nl, const double* scal,
                 const double* idh0, const double* idh1, void* stream) {
  return launch<double>(ptrs, M, nl, scal, idh0, idh1, stream);
}

const char* node_rhs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
