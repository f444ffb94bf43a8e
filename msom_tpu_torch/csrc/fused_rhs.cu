// Fused msqg tendency for Hopper (sm_90a): kernel K1 of the port.
//
// Replaces the Pallas TPU kernel `_rhs_kernel` (msom_tpu/models/pallas_rhs.py,
// entry `rhs_fused`) for the walled configurations (free slip and partial
// slip). From psi (nl, N, N) and the static coupling fields it computes, in
// one pass over device memory,
//
//   dq = -J(psi, zeta) + beta v                          (nl > 1 only)
//      - J(pp, zeta)                                      (with pp)
//      + strl(y) * idh1[l] * Jc_l  -  strl(y) * idh0[l] * Jc_l-1
//          Jc_l = -J(psi_l, psi_l+1) - J(pp_l, psi_l+1) - J(psi_l, pp_l+1)
//      - J(psi, zetap),  zetap = lap pp                   (_LS_RV)
//      + iRe  * (lap zeta + Gamma(zeta))                  (harmonic)
//      + iRe4 * (lap tmp + Gamma(tmp)),  tmp = lap zeta   (biharmonic)
//      - ek_top zeta_0 (layer 0), - ek_bot zeta_nl-1 (bottom layer)
//      - wind(y) (layer 0)
//      - J(psi_nl-1, topo) * iro(y) (bottom layer)        (with topo)
//      + qforc                                            (with qforc)
//
// with zeta = lap psi, -J the 12-point Arakawa bracket and Gamma the vertical
// stretching operator, plus the per-layer maximum |face velocity| of psi for
// the CFL controller, written per block to `umax_part` (nblocks, nl) and
// reduced by the caller (the JAX code also takes that max outside its
// kernel). With ENERGY_CONSERV advection (a `q` input) -J(psi, q) replaces
// -J(psi, zeta) and -J(psi_l, psi_l+1) leaves Jc. An absent field is a null
// pointer, and its terms are skipped.
//
// Design. One block computes a TY x TX tile of outputs for all nl layers.
// psi is staged in shared memory with a 3-cell halo, zeta on a 2-cell halo,
// tmp = lap zeta on a 1-cell halo, and the biharmonic is formed at the
// outputs. pp is staged like psi on a 1-cell halo (2 with _LS_RV, whose
// zetap = lap pp is then staged on a 1-cell halo like tmp). q and topo are
// read once per bracket straight from device memory through the ring rule
// (`nb_ring`): they enter one bracket each and need no derived field.
// Layers couple only through l-1 and l+1, and all nl layers of the tile are
// held at once (the wrapper refuses an option set whose planes exceed the
// 227 KB of shared memory a block may use). Each thread owns TY/BY output
// rows of one column and walks the layers in order, so the interface
// Jacobian Jc_l is computed once and carried to layer l+1 in a register.
//
// Where it is likely to go wrong, and what the code does:
//  1. Wall ghosts of DERIVED fields: the ghost ring of zeta, tmp and zetap
//     is a rule applied to the field's own interior (pallas_rhs.py `_yfix`
//     of zeta, tmp and lap pp), filled after the interior is computed; it
//     is never recomputed from psi's or pp's ghosts.
//  2. Corner ghosts compose x after y, so a Dirichlet corner is +interior:
//     one sign per reflected axis (ops/bc.py `pad`). Topography is Neumann:
//     sign +1 on both axes.
//  3. Cells beyond the first ghost ring are set to zero and never feed an
//     interior output: each stage reads at most one cell past its region.
//  4. Wall faces enter umax through psi's ghost ring (corners included),
//     exactly as max_face_speed_layers evaluates them.
//  5. The biharmonic stacks two Laplacians on zeta (three on psi): at
//     N = 2048 each multiplies by ~8/delta^2, so f32 cancellation, not the
//     index logic, sets the f32 tolerance of the comparison.
//  6. Partial slip (cslip = sbc / ((0.5 sbc + 1) delta^2) > 0): the EDGE
//     ghosts of zeta and of tmp are cslip * (parent_interior - parent_ghost)
//     with parent psi for zeta and zeta (slip ghosts included) for tmp,
//     which is `_views_slip`'s 2c psi and `_lap_ghostvals`' c (zeta - 2c psi);
//     the CORNER ghosts keep the Dirichlet fill of the field's own interior
//     (ops/ghost.py `ghosted_slip`).
//  7. At nl == 1 the whole advection block is skipped, the pp terms with it,
//     but not the topography.
//
// Bound. At 2048^2 x 4 in f32 the compulsory traffic of the uncoupled
// tendency is psi in and dq out, 2 * 4 * 2048^2 * 4 B = 134 MB, about 40 us
// at 3.35 TB/s; pp adds 4 planes and topo 1 (218 MB, about 65 us). The
// arithmetic is 130 to 240 FP32 operations per cell and layer
// (fused_rhs.bound_work counts them), 33 to 60 us at 67 TFLOP/s: the two
// bounds are of the same order. This version stages every plane in shared
// memory and recomputes the halo rings (zeta on (TY+4)(TX+4), tmp on
// (TY+2)(TX+2) cells per TY*TX outputs); it is written to be right, and its
// distance from the bound is measured by chip_smoke.py.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32, TY = 32;          // outputs per block
constexpr int BX = 32, BY = 8;           // threads per block
constexpr int RPT = TY / BY;             // output rows per thread
constexpr int NTH = BX * BY;
constexpr int MAXL = 16;                 // most layers the kernel takes
constexpr int PW = TX + 6, PH = TY + 6;  // psi, 3-cell halo
constexpr int ZW = TX + 4, ZH = TY + 4;  // zeta, 2-cell halo
constexpr int MW = TX + 2, MH = TY + 2;  // tmp = lap zeta, 1-cell halo
constexpr int PSZ = PW * PH, ZSZ = ZW * ZH, MSZ = MW * MH;

// Order of the device pointers handed to the C entry points.
enum Ptr { PSI, STRL, WIND, DQ, UMAX, PP, Q, TOPO, IRO, QFORC, NPTRS };

struct Params {
  int N, nl;
  double delta, beta, iRe, iRe4, ek_top, ek_bot, cslip;
  double idh0[MAXL], idh1[MAXL];
};

template <typename T>
struct Fields {
  const T *psi, *strl, *wind, *pp, *q, *topo, *iro, *qforc;
  T *dq, *umax_part;
};

// pp's halo: 2 cells when zetap = lap pp is formed from it, else 1.
constexpr int pp_halo(int flsrv) { return flsrv ? 2 : 1; }

size_t smem_bytes(int nl, int itemsize, int has_pg, int flsrv) {
  size_t cells = (size_t)nl * (PSZ + ZSZ + MSZ) + (NTH / 32) * nl;
  if (has_pg) {
    const int hp = pp_halo(flsrv);
    cells += (size_t)nl * (TX + 2 * hp) * (TY + 2 * hp);
    if (flsrv) cells += (size_t)nl * MSZ;
  }
  return (size_t)itemsize * cells;
}

// Reflect a first-ring ghost index onto the interior: returns the interior
// index and multiplies `s` by `sign` once per reflected axis (Dirichlet,
// sign -1: ghost = -interior, corners +interior; Neumann, sign +1).
template <typename T>
__device__ __forceinline__ int reflect(int g, int N, T& s, T sign) {
  if (g < 0) { s *= sign; return 0; }
  if (g >= N) { s *= sign; return N - 1; }
  return g;
}

__device__ __forceinline__ bool in_ring(int g, int N) {
  return g >= -1 && g <= N;
}

__device__ __forceinline__ bool interior(int g, int N) {
  return g >= 0 && g < N;
}

// The plane sizes of the staging helpers are template parameters: their
// index arithmetic divides by them for every staged cell, and a division by
// a run-time value costs an order of magnitude more than one by a constant.

// Stage an input field (nl, N, N) into shared memory as (nl, h, w) planes
// whose cell (0, 0) is global (gy0, gx0): interior cells as they are, the
// first ghost ring from the Dirichlet rule, zero beyond it (hazard 3).
template <typename T, int h, int w>
__device__ __forceinline__ void stage_input(T* dst, const T* __restrict__ src,
                                            int nl, int gy0, int gx0, int N,
                                            int tid) {
  constexpr int plane = h * w;
  const size_t NN = (size_t)N * N;
  for (int k = tid; k < nl * plane; k += NTH) {
    const int l = k / plane, r = k % plane, iy = r / w, ix = r % w;
    const int gy = gy0 + iy, gx = gx0 + ix;
    T v = T(0);
    if (in_ring(gy, N) && in_ring(gx, N)) {
      T s = T(1);
      const int ry = reflect(gy, N, s, T(-1)), rx = reflect(gx, N, s, T(-1));
      v = s * src[l * NN + (size_t)ry * N + rx];
    }
    dst[k] = v;
  }
}

// f = lap(parent) at the interior cells of f's (nl, h, w) planes; parent's
// planes are (h + 2) x (w + 2) and hold one more halo cell on every side.
template <typename T, int h, int w>
__device__ __forceinline__ void stage_laplacian(T* f, const T* parent, int nl,
                                                int gy0, int gx0, int N,
                                                int tid, T id2) {
  constexpr int plane = h * w, pw = w + 2, pplane = (h + 2) * pw;
  for (int k = tid; k < nl * plane; k += NTH) {
    const int l = k / plane, r = k % plane, iy = r / w, ix = r % w;
    if (interior(gy0 + iy, N) && interior(gx0 + ix, N)) {
      const T* c = parent + l * pplane + (iy + 1) * pw + ix + 1;
      f[k] = (c[1] + c[-1] + c[pw] + c[-pw] - T(4) * c[0]) * id2;
    }
  }
}

// Ghost ring of a derived field held in shared memory as (nl, h, w) planes
// whose cell (0, 0) is global (gy0, gx0): the Dirichlet rule on the field's
// own interior values (hazards 1 and 2); with cslip != 0 the edge ghosts
// (one axis outside) are cslip * (parent_interior - parent_ghost) instead
// (hazard 6), parent being the (h + 2) x (w + 2) planes the field is the
// Laplacian of, their own ring already filled. Cells beyond the ring are
// zeroed (hazard 3). Reads only interior cells of f and writes only
// non-interior ones.
template <typename T, int h, int w>
__device__ __forceinline__ void fill_ghosts(T* f, int nl, int gy0, int gx0,
                                            int N, int tid, const T* parent,
                                            T cslip) {
  constexpr int plane = h * w, pw = w + 2, pplane = (h + 2) * pw;
  for (int k = tid; k < nl * plane; k += NTH) {
    const int l = k / plane, r = k % plane, iy = r / w, ix = r % w;
    const int gy = gy0 + iy, gx = gx0 + ix;
    if (interior(gy, N) && interior(gx, N)) continue;
    T v = T(0);
    if (in_ring(gy, N) && in_ring(gx, N)) {
      T s = T(1);
      const int ry = reflect(gy, N, s, T(-1)), rx = reflect(gx, N, s, T(-1));
      const int ky = iy + ry - gy, kx = ix + rx - gx;   // reflected cell
      const bool edge = ry == gy || rx == gx;           // else a corner
      if (cslip != T(0) && edge) {
        const T* pl = parent + l * pplane;
        v = cslip * (pl[(ky + 1) * pw + kx + 1] - pl[(iy + 1) * pw + ix + 1]);
      } else {
        v = s * f[k - r + ky * w + kx];
      }
    }
    f[k] = v;
  }
}

// The eight neighbours of a cell.
template <typename T>
struct Nb {
  T e, w, n, s, ne, nw, se, sw;
};

// Neighbours of the cell p points at in a shared-memory plane of row
// stride wp.
template <typename T>
__device__ __forceinline__ Nb<T> nb_at(const T* p, int wp) {
  return {p[1],      p[-1],     p[wp],      p[-wp],
          p[wp + 1], p[wp - 1], p[-wp + 1], p[-wp - 1]};
}

// One value of an (N, N) field in device memory, first ghost ring included:
// ghost = sign * interior per reflected axis. Indices further out clamp to
// the wall cell; only masked threads of a partial tile reach them.
template <typename T>
__device__ __forceinline__ T ring_read(const T* __restrict__ f, int gy, int gx,
                                       int N, T sign) {
  T s = T(1);
  const int ry = reflect(gy, N, s, sign), rx = reflect(gx, N, s, sign);
  return s * f[(size_t)ry * N + rx];
}

// Neighbours of cell (gy, gx) of an (N, N) field read from device memory.
template <typename T>
__device__ __forceinline__ Nb<T> nb_ring(const T* __restrict__ f, int gy,
                                         int gx, int N, T sign) {
  return {ring_read(f, gy, gx + 1, N, sign),
          ring_read(f, gy, gx - 1, N, sign),
          ring_read(f, gy + 1, gx, N, sign),
          ring_read(f, gy - 1, gx, N, sign),
          ring_read(f, gy + 1, gx + 1, N, sign),
          ring_read(f, gy + 1, gx - 1, N, sign),
          ring_read(f, gy - 1, gx + 1, N, sign),
          ring_read(f, gy - 1, gx - 1, N, sign)};
}

// -J(p, q), the 12-point Arakawa bracket (ops/ghost.arakawa_mjac_g).
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
  return (f[1] + f[-1] + f[w] + f[-w] - T(4) * f[0]) * id2;
}

// Gamma(a)[l] at one cell; a points at layer l's cell, layers `plane` apart.
template <typename T>
__device__ __forceinline__ T gamma_at(const T* a, int plane, int l, int nl,
                                      const T* s, int N, int gy,
                                      const Params& p) {
  T g = T(0);
  if (l > 0) g += T(p.idh0[l]) * (s[(l - 1) * N + gy] * (a[-plane] - a[0]));
  if (l < nl - 1) g += T(p.idh1[l]) * (s[l * N + gy] * (a[plane] - a[0]));
  return g;
}

// COUPLED = false is the uncoupled free-slip tendency: every coupling term
// below is compiled out, which keeps that launch at its registers and its
// speed. COUPLED = true takes the options at run time from the null
// pointers of F and from p.cslip; HP is pp's halo (pp_halo), 2 with _LS_RV.
// The coupled f32 kernel is held to two blocks an SM (128 registers): left
// alone it takes 208 registers, one block an SM, and waits on latency.
template <typename T, bool COUPLED, int HP>
__global__ void __launch_bounds__(NTH, (COUPLED && sizeof(T) == 4) ? 2 : 1)
rhs_kernel(const Fields<T> F, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const int N = p.N, nl = p.nl;
  const bool has_pg = COUPLED && F.pp != nullptr;
  const bool flsrv = COUPLED && HP == 2;
  const bool has_q = COUPLED && F.q != nullptr;
  constexpr int QH = TY + 2 * HP, QW = TX + 2 * HP, QSZ = QW * QH;  // pp
  T* sp = reinterpret_cast<T*>(smem_raw);  // psi   (nl, PH, PW)
  T* sz = sp + nl * PSZ;                   // zeta  (nl, ZH, ZW)
  T* sm = sz + nl * ZSZ;                   // tmp   (nl, MH, MW)
  T* sred = sm + nl * MSZ;                 // (NTH/32, nl) warp maxima
  T* spp = sred + (NTH / 32) * nl;         // pp    (nl, QH, QW)
  T* szp = spp + (has_pg ? nl * QSZ : 0);  // zetap (nl, MH, MW)

  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * BX + threadIdx.x;
  const size_t NN = (size_t)N * N;
  const T id2 = T(1.0 / (p.delta * p.delta));
  const T i12d2 = T(1.0 / (12.0 * p.delta * p.delta));
  const T i2d = T(1.0 / (2.0 * p.delta));
  const T cslip = COUPLED ? T(p.cslip) : T(0);

  // 1. psi on a 3-cell halo and pp on its own, first ring by the Dirichlet
  //    rule
  stage_input<T, PH, PW>(sp, F.psi, nl, y0 - 3, x0 - 3, N, tid);
  if (has_pg)
    stage_input<T, QH, QW>(spp, F.pp, nl, y0 - HP, x0 - HP, N, tid);
  __syncthreads();

  // 2. zeta = lap psi at the interior cells of its 2-cell halo, then its
  //    ghost ring (from zeta's own interior; slip edges from psi); zetap =
  //    lap pp likewise on a 1-cell halo, always by the Dirichlet rule
  stage_laplacian<T, ZH, ZW>(sz, sp, nl, y0 - 2, x0 - 2, N, tid, id2);
  if (flsrv)
    stage_laplacian<T, MH, MW>(szp, spp, nl, y0 - 1, x0 - 1, N, tid, id2);
  __syncthreads();
  fill_ghosts<T, ZH, ZW>(sz, nl, y0 - 2, x0 - 2, N, tid, sp, cslip);
  if (flsrv)
    fill_ghosts<T, MH, MW>(szp, nl, y0 - 1, x0 - 1, N, tid, spp, T(0));
  __syncthreads();

  // 3. tmp = lap zeta on a 1-cell halo, ghost ring from tmp's interior
  //    (slip edges from zeta)
  stage_laplacian<T, MH, MW>(sm, sz, nl, y0 - 1, x0 - 1, N, tid, id2);
  __syncthreads();
  fill_ghosts<T, MH, MW>(sm, nl, y0 - 1, x0 - 1, N, tid, sz, cslip);
  __syncthreads();

  // 4. the tendency at the outputs, layer by layer
  const int ox = threadIdx.x, gx = x0 + ox;
  T jprev[RPT];   // the interface Jacobian Jc_l-1 at this thread's cells
#pragma unroll
  for (int j = 0; j < RPT; ++j) jprev[j] = T(0);

  for (int l = 0; l < nl; ++l) {
    T umx = T(0);
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int oy = threadIdx.y + BY * j, gy = y0 + oy;
      const int gyc = gy < N ? gy : N - 1;   // profile row (masked rows)
      const T* P = sp + l * PSZ + (oy + 3) * PW + ox + 3;
      const T* Z = sz + l * ZSZ + (oy + 2) * ZW + ox + 2;
      const T* M = sm + l * MSZ + (oy + 1) * MW + ox + 1;
      const T* Q = spp + l * QSZ + (oy + HP) * QW + ox + HP;
      const Nb<T> pn = nb_at(P, PW);
      T acc = T(0);
      if (nl > 1) {   // hazard 7
        const Nb<T> zn = nb_at(Z, ZW);
        if (has_q)
          acc = mjac(pn, nb_ring(F.q + l * NN, gy, gx, N, T(-1)), i12d2);
        else
          acc = mjac(pn, zn, i12d2);
        acc += T(p.beta) * (pn.w - pn.e) * i2d;
        if (has_pg) acc += mjac(nb_at(Q, QW), zn, i12d2);
        T jnext = T(0);
        if (l < nl - 1) {
          const Nb<T> pup = nb_at(P + PSZ, PW);
          if (has_pg)
            jnext = mjac(nb_at(Q, QW), pup, i12d2)
                  + mjac(pn, nb_at(Q + QSZ, QW), i12d2);
          if (!has_q) jnext += mjac(pn, pup, i12d2);
          acc += F.strl[l * N + gyc] * jnext * T(p.idh1[l]);
        }
        if (l > 0) acc -= F.strl[(l - 1) * N + gyc] * jprev[j] * T(p.idh0[l]);
        jprev[j] = jnext;
        if (flsrv)
          acc += mjac(pn, nb_at(szp + l * MSZ + (oy + 1) * MW + ox + 1, MW),
                      i12d2);
      }
      if (p.iRe != 0.0) {
        acc += T(p.iRe) * M[0];
        if (nl > 1)
          acc += T(p.iRe) * gamma_at(Z, ZSZ, l, nl, F.strl, N, gyc, p);
      }
      if (p.iRe4 != 0.0) {
        T bih = lap5(M, MW, id2);
        if (nl > 1) bih += gamma_at(M, MSZ, l, nl, F.strl, N, gyc, p);
        acc += T(p.iRe4) * bih;
      }
      if (l == 0 && p.ek_top != 0.0) acc -= T(p.ek_top) * Z[0];
      if (l == nl - 1 && p.ek_bot != 0.0) acc -= T(p.ek_bot) * Z[0];
      if (l == 0) acc -= F.wind[gyc];
      if (COUPLED && F.topo != nullptr && l == nl - 1)
        acc += mjac(pn, nb_ring(F.topo, gy, gx, N, T(1)), i12d2) * F.iro[gyc];

      // the four faces of this cell (hazard 4: wall faces via the ghosts)
      const T uc = -(pn.n - pn.s) * i2d;
      const T ucW = -(pn.nw - pn.sw) * i2d;
      const T ucE = -(pn.ne - pn.se) * i2d;
      const T vc = (pn.e - pn.w) * i2d;
      const T vcS = (pn.se - pn.sw) * i2d;
      const T vcN = (pn.ne - pn.nw) * i2d;
      const T speed = fmax(fmax(fabs(T(0.5) * (uc + ucW)),
                                fabs(T(0.5) * (uc + ucE))),
                           fmax(fabs(T(0.5) * (vc + vcS)),
                                fabs(T(0.5) * (vc + vcN))));
      if (gy < N && gx < N) {
        const size_t o = l * NN + (size_t)gy * N + gx;
        if (COUPLED && F.qforc != nullptr) acc += F.qforc[o];
        F.dq[o] = acc;
        umx = fmax(umx, speed);
      }
    }
    for (int o = 16; o > 0; o >>= 1)
      umx = fmax(umx, __shfl_xor_sync(0xffffffffu, umx, o));
    if ((tid & 31) == 0) sred[(tid >> 5) * nl + l] = umx;
  }
  __syncthreads();
  if (tid < nl) {
    T m = sred[tid];
    for (int w = 1; w < NTH / 32; ++w) m = fmax(m, sred[w * nl + tid]);
    F.umax_part[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * nl + tid] = m;
  }
}

template <typename T>
int run(void (*kernel)(const Fields<T>, const Params), const Fields<T>& F,
        const Params& p, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.N + TX - 1) / TX, (p.N + TY - 1) / TY), block(BX, BY);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(F, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* const* ptrs, int N, int nl, int flsrv,
           const double* scal, const double* idh0, const double* idh1,
           void* stream) {
  if (nl < 1 || nl > MAXL || N < 1) return (int)cudaErrorInvalidValue;
  if (!ptrs[PSI] || !ptrs[WIND] || !ptrs[DQ] || !ptrs[UMAX]
      || (nl > 1 && !ptrs[STRL]) || (flsrv && !ptrs[PP])
      || (ptrs[TOPO] && !ptrs[IRO]))
    return (int)cudaErrorInvalidValue;
  Fields<T> F;
  F.psi = static_cast<const T*>(ptrs[PSI]);
  F.strl = static_cast<const T*>(ptrs[STRL]);
  F.wind = static_cast<const T*>(ptrs[WIND]);
  F.pp = static_cast<const T*>(ptrs[PP]);
  F.q = static_cast<const T*>(ptrs[Q]);
  F.topo = static_cast<const T*>(ptrs[TOPO]);
  F.iro = static_cast<const T*>(ptrs[IRO]);
  F.qforc = static_cast<const T*>(ptrs[QFORC]);
  F.dq = static_cast<T*>(const_cast<void*>(ptrs[DQ]));
  F.umax_part = static_cast<T*>(const_cast<void*>(ptrs[UMAX]));
  Params p;
  p.N = N;
  p.nl = nl;
  p.delta = scal[0];
  p.beta = scal[1];
  p.iRe = scal[2];
  p.iRe4 = scal[3];
  p.ek_top = scal[4];
  p.ek_bot = scal[5];
  p.cslip = scal[6];
  for (int l = 0; l < MAXL; ++l) {
    p.idh0[l] = l < nl ? idh0[l] : 0.0;
    p.idh1[l] = l < nl ? idh1[l] : 0.0;
  }
  const bool coupled = F.pp || F.q || F.topo || F.qforc || p.cslip != 0.0;
  const size_t smem = smem_bytes(nl, sizeof(T), F.pp != nullptr, flsrv);
  if (!coupled) return run(rhs_kernel<T, false, 1>, F, p, smem, stream);
  return flsrv ? run(rhs_kernel<T, true, 2>, F, p, smem, stream)
               : run(rhs_kernel<T, true, 1>, F, p, smem, stream);
}

}  // namespace

extern "C" {

// Number of (TY x TX) tiles, the rows of `umax_part`.
int fused_rhs_num_blocks(int N) {
  return ((N + TX - 1) / TX) * ((N + TY - 1) / TY);
}

// Dynamic shared memory of one block, in bytes, for an option set.
long long fused_rhs_smem_bytes(int nl, int itemsize, int has_pg, int flsrv) {
  return (long long)smem_bytes(nl, itemsize, has_pg, flsrv);
}

// ptrs = device pointers in the order of `Ptr` (psi, strl, wind, dq,
// umax_part, pp, q, topo, iro, qforc), null where a field is absent: pp
// switches the large-scale coupling on, q ENERGY_CONSERV advection, topo
// (with iro) the topography, qforc the forcing. flsrv != 0 adds _LS_RV
// (needs pp). scal = {delta, beta, iRe, iRe4, ek_top, ek_bot, cslip};
// idh0/idh1 host arrays of nl doubles. Launches on `stream` and returns
// the CUDA error code of the launch (0 on success).
int fused_rhs_f32(const void* const* ptrs, int N, int nl, int flsrv,
                  const double* scal, const double* idh0, const double* idh1,
                  void* stream) {
  return launch<float>(ptrs, N, nl, flsrv, scal, idh0, idh1, stream);
}

int fused_rhs_f64(const void* const* ptrs, int N, int nl, int flsrv,
                  const double* scal, const double* idh0, const double* idh1,
                  void* stream) {
  return launch<double>(ptrs, N, nl, flsrv, scal, idh0, idh1, stream);
}

const char* fused_rhs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
