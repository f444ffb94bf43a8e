"""Direct spectral PV inversion (the port of `msom_tpu.solvers.spectral`).

The msqg inversion solves lap(psi) + Gamma(psi) = q. With spatially uniform
stretching the vertical modes diagonalise Gamma with constant nl x nl
matrices (l2m, m2l), and each modal Helmholtz problem
lap(p_m) + iBu_m p_m = q_m is diagonalised by the DST-II basis of the
5-point Laplacian with ghost = -interior (eigenvalues
-(4/h^2) sin^2(pi k / (2N)), k = 1..N). So the solve is: modal matmul ->
2-D DST-II -> multiply by 1/(lam_y + lam_x + iBu) -> inverse -> matmul back.

Transform selection is the JAX package's (`spectral.py:195-219`):
  * "auto", f32, Dirichlet, 512 <= N <= 4096, N a power of 2: the folded
    matmul DST (solvers/ctdst.py), with inv_den permuted at build time;
  * "auto", f32, Dirichlet, N <= 4096 otherwise, or "matmul": the (N, N)
    basis matmul (periodic: the real Fourier basis `fourier_matrix`);
  * "auto" in f64, or "fft": DST-II through a DCT-II computed with one FFT
    of the same length (Makhoul's reordering), since torch has no DCT;
  * "auto" or "fft", periodic, in every type: rfft2 / irfft2 (cuFFT on
    the card; the JAX package's jnp.fft), inv_den of shape (nl, N, N//2+1);
  * "factored": the folded DST at any power-of-2 N >= 16 (Dirichlet only).
Periodic: where a denominator is 0 (the barotropic mean) its inverse is 0,
which fixes the gauge (the solution's mean). With `fused_mm` the
basis-matmul solve, on either basis, runs in the hand-written kernel K7
(solvers/fused_spectral.py) instead of torch.matmul.

`build_spectral_node` is the qg-node family's direct inversion: the
(N-1)^2 interior vertices with a zero ring are diagonalised by the DST-I
basis (`dst1_matrix`) times the vertical modes; in f32 at 512 <= N, N a
power of 2, through the folded DST-I (ctdst.FoldedDST1), otherwise (f64
among them) through the (N-1)^2 basis matmul.

`refine=True` is the JAX package's bf16 + refinement solve
(`spectral.py:232-270`, `:322-325`): the single-matrix basis with inv_den
in natural order and no fold; a solve is one reduced-precision pass of
the basis-matmul chain, the residual r = q_m - lap(p_m) - iBu_m p_m with
the 5-point stencil under the model BC in the working type
(`modal_residual`), and one more pass on r added to p_m. A pass is what
JAX's Precision.DEFAULT is on each device: on a CUDA float32 tensor one
bf16 pass (bf16 operands, float32 accumulation and float32 outputs:
`torch.mm`/`torch.bmm` with `out_dtype`, the bf16 copy of S cast once at
build), elsewhere (the CPU, float64) the working type's own products.
`refine_pass_reference` is the plain version of the bf16 pass: operands
rounded to bf16, float32 products. The modal projections stay at full
precision and TF32 stays off. "auto" means False, as in JAX, which
measured refinement as no gain on its TPU (`spectral.py:232-250`).
Where no basis matrix is built (float64 "auto", "fft", the periodic
rfft) the flag is kept and the solve does not read it, as in JAX.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from msom_tpu_torch.ops import ghost, modes
from msom_tpu_torch.ops.bc import BC
from msom_tpu_torch.solvers import ctdst, fused_spectral


@dataclasses.dataclass(frozen=True)
class SpectralData:
    """Precomputed inverse modal denominators + mode matrices. With `fac`
    set, inv_den is in the folded transform's permuted order; with S set,
    the basis-matmul path runs (in kernel K7 when `fused_mm`); with
    neither, the FFT-based DST. `mm` holds the TF32 split of S and S^T
    that K7 reads in float32. With `refine` and S, the bf16 + refinement
    solve, whose residual reads iBu, delta and periodic, and whose bf16
    pass reads Sb."""
    inv_den: torch.Tensor         # (nl, N, N or N//2+1): 1/(lam_y + lam_x
    #                               + iBu_m), 0 where that is 0
    l2m: torch.Tensor | None      # (nl, nl) layer->mode (None when nl == 1)
    m2l: torch.Tensor | None      # (nl, nl) mode->layer
    S: torch.Tensor | None        # (N, N) orthonormal DST-II or Fourier basis
    fac: ctdst.FoldedDST | ctdst.FoldedDST1 | None
    fused_mm: bool = False
    mm: fused_spectral.Basis | None = None   # K7's f32 split of S and S^T
    periodic: bool = False        # with neither S nor fac: rfft2 / irfft2
    iBu: torch.Tensor | None = None   # (nl,) modal Helmholtz coefficients
    delta: float = 0.0            # grid spacing (the residual's stencil)
    refine: bool = False          # bf16 passes + one refinement pass
    Sb: torch.Tensor | None = None    # S in bf16 (refine in float32)


def dst_matrix(N: int, dtype=np.float64) -> np.ndarray:
    """Orthonormal DST-II matrix: S[k, i] = c_k sin(pi (k+1)(i+1/2)/N), row k
    <-> sine wavenumber k+1. S is orthogonal: the inverse is S.T."""
    k = np.arange(N)[:, None]
    i = np.arange(N)[None, :]
    S = np.sin(np.pi * (k + 1) * (i + 0.5) / N)
    c = np.full(N, np.sqrt(2.0 / N))
    c[-1] = np.sqrt(1.0 / N)
    return (c[:, None] * S).astype(dtype)


def fourier_matrix(N: int, dtype=np.float64):
    """(R, freq): the orthonormal real eigenbasis of the periodic 1-D
    discrete Laplacian (N even) and each row's frequency. Row 0 is
    1/sqrt(N); rows 2m-1, 2m are sqrt(2/N) cos and sin of frequency m for
    m = 1 .. N/2-1; row N-1 is (-1)^i/sqrt(N), the Nyquist mode. R L R^T
    is diagonal with eigenvalues -(4/h^2) sin^2(pi freq / N)."""
    if N % 2:
        raise ValueError(f"fourier_matrix needs an even N, got {N}")
    i = np.arange(N)
    R = np.empty((N, N))
    freq = np.empty(N)
    R[0] = 1.0 / np.sqrt(N)
    freq[0] = 0
    for m in range(1, N // 2):
        ph = 2.0 * np.pi * m * i / N
        R[2 * m - 1] = np.sqrt(2.0 / N) * np.cos(ph)
        R[2 * m] = np.sqrt(2.0 / N) * np.sin(ph)
        freq[2 * m - 1] = freq[2 * m] = m
    R[N - 1] = ((-1.0) ** i) / np.sqrt(N)
    freq[N - 1] = N // 2
    return R.astype(dtype), freq


def _dct2_last(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal DCT-II along the last axis with one length-N FFT
    (Makhoul 1980): v = [x0, x2, x4, ..., x5, x3, x1], then
    X[k] = s_k Re(exp(-i pi k / 2N) FFT(v)[k])."""
    N = x.shape[-1]
    v = torch.cat([x[..., 0::2], torch.flip(x[..., 1::2], (-1,))], dim=-1)
    V = torch.fft.fft(v, dim=-1)
    k = torch.arange(N, device=x.device, dtype=x.dtype)
    w = torch.polar(torch.ones_like(k), -math.pi * k / (2 * N))
    s = torch.full((N,), math.sqrt(2.0 / N), dtype=x.dtype, device=x.device)
    s[0] = math.sqrt(1.0 / N)
    return (V * w).real * s


def _idct2_last(X: torch.Tensor) -> torch.Tensor:
    """Inverse of _dct2_last: Y = X / s_k, W[k] = Y[k] - i Y[N-k] (Y[N] = 0),
    v = IFFT(exp(i pi k / 2N) W) (real), then undo the reordering."""
    N = X.shape[-1]
    s = torch.full((N,), math.sqrt(2.0 / N), dtype=X.dtype, device=X.device)
    s[0] = math.sqrt(1.0 / N)
    Y = X / s
    Yr = torch.cat([torch.zeros_like(Y[..., :1]),
                    torch.flip(Y[..., 1:], (-1,))], dim=-1)   # Y[N-k]
    k = torch.arange(N, device=X.device, dtype=X.dtype)
    w = torch.polar(torch.ones_like(k), math.pi * k / (2 * N))
    v = torch.fft.ifft(w * torch.complex(Y, -Yr), dim=-1).real
    x = torch.empty_like(v)
    h = (N + 1) // 2
    x[..., 0::2] = v[..., :h]
    x[..., 1::2] = torch.flip(v[..., h:], (-1,))
    return x


def _sign(N: int, like: torch.Tensor) -> torch.Tensor:
    s = torch.ones(N, dtype=like.dtype, device=like.device)
    s[1::2] = -1.0
    return s


def dst2(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Orthonormal DST-II along `axis` (output index j <-> sine k = j+1):
    DST2(x)[k] = flip_k(DCT2((-1)^i x)[k])."""
    x = torch.movedim(x, axis, -1)
    c = _dct2_last(x * _sign(x.shape[-1], x))
    return torch.movedim(torch.flip(c, (-1,)), -1, axis)


def idst2(X: torch.Tensor, axis: int) -> torch.Tensor:
    """Inverse of dst2 (its exact adjoint under the orthonormal scaling)."""
    X = torch.movedim(X, axis, -1)
    z = _idct2_last(torch.flip(X, (-1,)))
    return torch.movedim(z * _sign(z.shape[-1], z), -1, axis)


def build_spectral(*, nl: int, N: int, L0: float, dh=None, s_profile=None,
                   lam=None, periodic: bool = False, dtype=torch.float32,
                   transform: str = "auto", refine: str | bool = "auto",
                   fused_mm: bool = False,
                   device="cuda") -> SpectralData:
    """Precompute the modal inverse denominators (JAX `build_spectral`).

    s_profile holds the (nl-1,) uniform stretching values (Fr/Ro)^2 that
    the vertical modes diagonalise; or `lam` holds (nl,) per-layer
    Helmholtz coefficients of layers that are already uncoupled (newqg's
    -1/Rd^2 in the bottom layer, reference newqg/qg.h:148-157), with no
    mode matrices; nl = 1 with neither is the plain Poisson case.
    `periodic` takes the doubly periodic basis (rfft2, or with the matmul
    transform `fourier_matrix`). `fused_mm` sends the basis-matmul solve
    through kernel K7: it needs the matmul transform and a size and type
    that fused_spectral.check_gate takes. `refine` selects the bf16 +
    refinement solve ("auto": False); it refuses the folded transform and
    K7, and where "auto" would fold it keeps the basis matrix instead."""
    if refine == "auto":
        refine = False
    if fused_mm and refine:
        # JAX's solve would bypass its Pallas kernel here; an explicit
        # request for K7 that is not honoured would be a hidden fallback
        raise ValueError("fused_mm and refine are mutually exclusive (the "
                         "refinement's passes are not kernel K7)")
    if fused_mm:
        if transform != "matmul":
            raise ValueError(f"fused_mm needs transform='matmul', got "
                             f"{transform!r}")
        fused_spectral.check_gate(dtype, N)
    h = L0 / N
    if lam is not None:
        iBu = np.asarray(lam, np.float64).reshape(nl)
        l2m = m2l = None
    elif nl > 1:
        vm = modes.eigmod(np.asarray(dh, np.float64)[:nl],
                          np.asarray(s_profile, np.float64))
        iBu = np.asarray(vm.iBu, np.float64)
        l2m = torch.as_tensor(vm.l2m, dtype=dtype).to(device)
        m2l = torch.as_tensor(vm.m2l, dtype=dtype).to(device)
    else:
        iBu = np.zeros(1)
        l2m = m2l = None

    f32 = torch.finfo(dtype).bits == 32
    pow2 = N & (N - 1) == 0
    if periodic and transform == "factored":
        raise ValueError("transform='factored' covers the Dirichlet (DST) "
                         "basis only; periodic keeps the rfft/matmul paths")
    if transform == "factored" and refine is True:
        raise ValueError("transform='factored' and refine are mutually "
                         "exclusive (refinement needs the naturally-ordered "
                         "single-matrix basis)")
    # refine keeps the single-matrix basis with inv_den in natural order
    use_fac = not refine and (transform == "factored" or (
        transform == "auto" and f32 and not periodic and 512 <= N <= 4096
        and pow2))
    use_mm = transform == "matmul" or (transform == "auto" and f32
                                       and N <= 4096 and not periodic)

    basis = None
    if periodic and use_mm:
        basis, freq = fourier_matrix(N)
        lam_y = lam_x = -(4.0 / h ** 2) * np.sin(np.pi * freq / N) ** 2
    elif periodic:
        lam_y = -(4.0 / h ** 2) * np.sin(
            np.pi * np.arange(N, dtype=np.float64) / N) ** 2
        lam_x = lam_y[:N // 2 + 1]
    else:
        k = np.arange(1, N + 1, dtype=np.float64)
        lam_y = lam_x = -(4.0 / h ** 2) * np.sin(np.pi * k / (2 * N)) ** 2
        if use_mm:
            basis = dst_matrix(N)
    den = lam_y[None, :, None] + lam_x[None, None, :] + iBu[:, None, None]
    with np.errstate(divide="ignore"):
        inv = np.where(den != 0.0, 1.0 / np.where(den != 0.0, den, 1.0), 0.0)

    S = fac = mm = Sb = None
    if basis is not None and not use_fac:
        S = torch.as_tensor(basis, dtype=dtype).to(device)
        if fused_mm and dtype == torch.float32:
            mm = fused_spectral.basis(S)
        if refine and dtype == torch.float32:
            Sb = S.to(torch.bfloat16)
    if use_fac:
        fac, perm = ctdst.build_fold(N, dtype, device)
        if fac is None:
            raise ValueError(f"transform='factored' needs a power-of-2 "
                             f"N >= 32, got {N}")
        # the folded transform emits modes in a permuted order: permute the
        # diagonal denominator once here instead of shuffling data per solve
        inv = inv[:, perm][:, :, perm]
    return SpectralData(inv_den=torch.as_tensor(inv, dtype=dtype).to(device),
                        l2m=l2m, m2l=m2l, S=S, fac=fac, fused_mm=fused_mm,
                        mm=mm, periodic=periodic,
                        iBu=torch.as_tensor(iBu, dtype=dtype).to(device),
                        delta=h, refine=bool(refine), Sb=Sb)


def _mm_solve(S: torch.Tensor, inv_den: torch.Tensor, qm: torch.Tensor,
              mm=torch.matmul) -> torch.Tensor:
    """One basis-matmul solve in modal space (S rows in natural order):
    the x transform, the y transform, the scale, and their inverses, each
    stage one product mm(a, b)."""
    Q = mm(S, mm(qm, S.T))
    return mm(mm(S.T, Q * inv_den), S)


def _bf16_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with bf16 operands, float32 accumulation and a float32 output
    (one MXU pass at JAX's Precision.DEFAULT), for (nl, m, k) @ (k, n) or
    (m, k) @ (nl, k, n); an operand already in bf16 is not cast again."""
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if b.ndim == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.view(*a.shape[:-1], b.shape[-1])
    return torch.bmm(a.expand(b.shape[0], *a.shape), b,
                     out_dtype=torch.float32)


def _bf16_mm_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of _bf16_mm: both operands rounded to bf16, then
    one product in float32."""
    def rnd(t):
        return t.to(torch.bfloat16).to(torch.float32)
    return torch.matmul(rnd(a), rnd(b))


def pass_product(data, like: torch.Tensor):
    """(basis, product) of one reduced-precision pass on `like`'s device
    and type: on a CUDA float32 tensor the bf16 copy of S and _bf16_mm,
    elsewhere S and the working type's own matmul (JAX's DEFAULT is full
    precision on its CPU). `data` is a SpectralData or the sharded form
    with S and Sb."""
    if like.is_cuda and like.dtype == torch.float32:
        if data.Sb is None:
            raise ValueError("the bf16 pass needs the bf16 basis Sb "
                             "(build_spectral(refine=True) in float32)")
        return data.Sb, _bf16_mm
    return data.S, torch.matmul


def refine_pass(data: SpectralData, qm: torch.Tensor) -> torch.Tensor:
    """One solve pass of the refinement in modal space (JAX `_mm_solve` at
    Precision.DEFAULT, spectral.py:273-285): bf16 on a CUDA float32
    tensor, else the working type's products."""
    S, mm = pass_product(data, qm)
    return _mm_solve(S, data.inv_den, qm, mm)


def refine_pass_reference(data: SpectralData,
                          qm: torch.Tensor) -> torch.Tensor:
    """The plain version of the card's bf16 pass on any device: every GEMM
    stage's operands rounded to bf16, the products in float32."""
    return _mm_solve(data.S.float(), data.inv_den, qm.float(),
                     _bf16_mm_reference)


def modal_residual(data, qm: torch.Tensor, pm: torch.Tensor, *,
                   ghost_fn=None) -> torch.Tensor:
    """r_m = q_m - lap(p_m) - iBu_m p_m with the 5-point stencil under the
    model BC, in the working type (JAX `modal_residual`, spectral.py:
    287-296). ghost_fn(f, bc) -> Ghosted gives the ghost ring (by default
    ops.ghost.ghosted; a sharded solve passes its halo exchange)."""
    bc = BC.PERIODIC if data.periodic else BC.DIRICHLET
    g = (ghost_fn or ghost.ghosted)(pm, bc)
    return qm - ghost.laplacian_g(g, data.delta) \
        - data.iBu[:, None, None] * pm


def solve_spectral(data: SpectralData, q: torch.Tensor) -> torch.Tensor:
    """psi = L^-1 q for q of shape (nl, N, N)."""
    qm = q if data.l2m is None else torch.einsum("ml,lyx->myx", data.l2m, q)
    if isinstance(data.fac, ctdst.FoldedDST1):
        Q = ctdst.fdst1_x(data.fac, ctdst.fdst1_y(data.fac, qm))
        pm = ctdst.ifdst1_y(data.fac,
                            ctdst.ifdst1_x(data.fac, Q * data.inv_den))
    elif data.fac is not None:
        Q = ctdst.fdst_x(data.fac, ctdst.fdst_y(data.fac, qm))
        pm = ctdst.ifdst_y(data.fac, ctdst.ifdst_x(data.fac, Q * data.inv_den))
    elif data.refine and data.S is not None:
        pm = refine_pass(data, qm)
        pm = pm + refine_pass(data, modal_residual(data, qm, pm))
    elif data.fused_mm:
        pm = fused_spectral.fused_mm_solve(data.S, data.inv_den,
                                           qm.contiguous(), data.mm)
    elif data.S is not None:
        pm = _mm_solve(data.S, data.inv_den, qm)
    elif data.periodic:
        P = torch.fft.rfft2(qm) * data.inv_den
        pm = torch.fft.irfft2(P, s=qm.shape[-2:])
    else:
        Q = dst2(dst2(qm, -1), -2)
        pm = idst2(idst2(Q * data.inv_den, -2), -1)
    return pm if data.m2l is None else torch.einsum("lm,myx->lyx", data.m2l,
                                                    pm)


def dst1_matrix(N: int, dtype=np.float64) -> np.ndarray:
    """Orthonormal DST-I matrix for the N-1 interior vertices of an
    N-interval wall-to-wall grid: S1[k, i] = sqrt(2/N) sin(pi (k+1)(i+1) / N),
    k, i = 0..N-2. Symmetric and orthogonal; it diagonalises the 5-point
    vertex Laplacian with a zero boundary ring (the qg-node inversion,
    qg-node/nodal-poisson.h), eigenvalues -(4/h^2) sin^2(pi (k+1) / (2N))."""
    k = np.arange(N - 1)[:, None]
    i = np.arange(N - 1)[None, :]
    return (np.sqrt(2.0 / N)
            * np.sin(np.pi * (k + 1) * (i + 1) / N)).astype(dtype)


def build_spectral_node(*, nl: int, N: int, L0: float, dh=None,
                        s_profile=None, iRd2_low: float = 0.0,
                        dtype=torch.float32, device="cuda") -> SpectralData:
    """Direct spectral inversion of the nodal PV system (JAX
    `build_spectral_node`), applicable when the mask is the default wall
    rectangle and the stratification is horizontally uniform: one exact
    solve of the interior vertices with a zero ring. `solve_spectral` takes
    the (nl, N-1, N-1) interior. s_profile: the (nl-1,) uniform S2 = f^2/N^2
    values; iRd2_low: the barotropic Helmholtz shift (qg_barotropic.h:
    114-118, nl == 1)."""
    h = L0 / N
    if nl > 1:
        vm = modes.eigmod(np.asarray(dh, np.float64)[:nl],
                          np.asarray(s_profile, np.float64))
        iBu = np.asarray(vm.iBu, np.float64)
        l2m = torch.as_tensor(vm.l2m, dtype=dtype).to(device)
        m2l = torch.as_tensor(vm.m2l, dtype=dtype).to(device)
    else:
        iBu = np.array([-float(iRd2_low)])
        l2m = m2l = None
    k = np.arange(1, N, dtype=np.float64)
    lam = -(4.0 / h ** 2) * np.sin(np.pi * k / (2 * N)) ** 2
    den = lam[None, :, None] + lam[None, None, :] + iBu[:, None, None]
    with np.errstate(divide="ignore"):
        inv = np.where(den != 0.0, 1.0 / np.where(den != 0.0, den, 1.0), 0.0)
    fac = S = None
    if torch.finfo(dtype).bits == 32 and N >= 512 and N & (N - 1) == 0:
        fac, perm = ctdst.build_fold1(N, dtype, device)
        inv = inv[:, perm][:, :, perm]
    else:
        S = torch.as_tensor(dst1_matrix(N), dtype=dtype).to(device)
    return SpectralData(inv_den=torch.as_tensor(inv, dtype=dtype).to(device),
                        l2m=l2m, m2l=m2l, S=S, fac=fac)
