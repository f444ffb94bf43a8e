"""Direct PV inversion for a stratification that varies in y only (the port
of `msom_tpu.solvers.vary`): varRo, and a Froude field frpg that is
constant along x.

The msqg inversion lap(psi) + Gamma(psi) = q has no constant vertical
modes when strl = (Fr/Ro)^2 varies, but a strl that varies in y only
keeps the operator separable in x:

    DST-II in x  ->  for each x-mode kx (eigenvalue lam_kx):
        a*psi_{j-1} + B_j(kx)*psi_j + a*psi_{j+1} = q_hat_j,
        a = 1/h^2,   B_j(kx) = Gamma_j + (lam_kx - 2/h^2) I
        (the wall rows j = 0, N-1 take another -1/h^2 on the diagonal:
         the Dirichlet ghost = -interior),

a block-tridiagonal system in y with nl x nl blocks Gamma_j (the
stretching tridiagonal at row y_j, ops.stretch conventions) and scalar
off-diagonal blocks a*I. Block Thomas solves it, with every inverse formed
once at build on the host in f64: W_j(kx) = (B_j - a^2 W_{j-1})^-1, stored
planes last, (nl, nl, N, Kx), in the model's type. A solve is then

    forward:   y_j   = W_j (r_j - a y_{j-1})
    backward:  psi_j = y_j - a W_j psi_{j+1}

for each of the Kx columns, N dependent rows each way. `method="scan"`
("auto") runs them in `fused_vary.sweep`: the hand-written kernel KV on a
CUDA tensor, its plain version (a row loop of torch ops) on a CPU tensor.
"blocked" (two-level) and "assoc" (log-depth prefix composition) compute
the same sweeps as torch ops on either device; the tests pin them against
"scan". The x transform is the folded DST (`ctdst.fdst_x`, f32 with
512 <= N <= 4096 a power of 2, which permutes the modes, so `lam` is
permuted at build) or the DST-II basis product.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from msom_tpu_torch.solvers import ctdst, fused_vary
from msom_tpu_torch.solvers.spectral import dst_matrix


@dataclasses.dataclass(frozen=True)
class VarySpectralData:
    """The x transform and the block-Thomas inverses of the y solve."""
    W: torch.Tensor                  # (nl, nl, N, Kx) forward-elim inverses
    S: torch.Tensor | None           # (N, N) DST-II basis, None with `fac`
    fac: ctdst.FoldedDST | None      # folded x transform (permuted modes)
    a: float                         # off-diagonal scalar 1/h^2


def applicable(strl) -> bool:
    """True when strl ((nl-1, N, N) or (nl-1, N, 1)) varies in y only: it
    is constant along x and not uniform."""
    if strl is None:
        return False
    s = np.asarray(strl)
    return bool(np.array_equal(s, np.broadcast_to(s[..., :1], s.shape))) \
        and not np.all(s == s[:, :1, :1])


def _gamma_blocks(s_prof: np.ndarray, idh0, idh1) -> np.ndarray:
    """(N, nl, nl) stretching blocks Gamma_j from the (nl-1, N) y-profile
    (ops.stretch conventions: Neumann vertical ends through idh0[0] =
    idh1[-1] = 0)."""
    nlm1, N = s_prof.shape
    nl = nlm1 + 1
    idh0 = np.asarray(idh0, np.float64)
    idh1 = np.asarray(idh1, np.float64)
    G = np.zeros((N, nl, nl))
    for l in range(nl):
        if l > 0:
            G[:, l, l - 1] += idh0[l] * s_prof[l - 1]
            G[:, l, l] -= idh0[l] * s_prof[l - 1]
        if l < nl - 1:
            G[:, l, l + 1] += idh1[l] * s_prof[l]
            G[:, l, l] -= idh1[l] * s_prof[l]
    return G


def build_spectral_vary(*, nl: int, N: int, L0: float, s_prof, idh0, idh1,
                        dtype=torch.float32, transform: str = "auto",
                        device="cuda") -> VarySpectralData:
    """The factors on `device`, formed on the host in f64. s_prof: the
    (nl-1, N) y-profile of strl."""
    h = L0 / N
    a = 1.0 / (h * h)
    k = np.arange(1, N + 1, dtype=np.float64)
    lam = -(4.0 / h ** 2) * np.sin(np.pi * k / (2 * N)) ** 2   # DST-II order

    fac = S = None
    if (transform in ("auto", "factored")
            and torch.finfo(dtype).bits == 32 and 512 <= N <= 4096
            and N & (N - 1) == 0):
        fac, perm = ctdst.build_fold(N, dtype, device)
        lam = lam[perm]        # the factors follow the folded mode order
    else:
        S = torch.as_tensor(dst_matrix(N), dtype=dtype).to(device)

    G = _gamma_blocks(np.asarray(s_prof, np.float64), idh0, idh1)
    eye = np.eye(nl)
    # diagonal blocks B_j(kx) = G_j + (lam_kx - 2a) I, the wall rows -a more
    diag_shift = np.full(N, -2.0 * a)
    diag_shift[0] -= a
    diag_shift[-1] -= a
    W = np.empty((N, len(lam), nl, nl))
    prev = None
    for j in range(N):
        B = G[j][None] + (lam[:, None, None] + diag_shift[j]) * eye[None]
        if prev is not None:
            B = B - (a * a) * prev
        prev = np.linalg.inv(B)
        W[j] = prev
    W = torch.as_tensor(W.transpose(2, 3, 0, 1), dtype=dtype).to(device)
    return VarySpectralData(W=W.contiguous(), S=S, fac=fac, a=a)


def _mm(A, B, nl):
    """Block products of (nl*nl, ...) planes, written out plane by plane."""
    return torch.stack([sum(A[i * nl + b] * B[b * nl + c] for b in range(nl))
                        for i in range(nl) for c in range(nl)])


def _mv(A, x, nl):
    """(nl*nl, ...) blocks times (nl, ...) vectors."""
    return torch.stack([sum(A[i * nl + b] * x[b] for b in range(nl))
                        for i in range(nl)])


def _affine_chain(P, c, nl, reverse=False):
    """y_j = c_j + P_j y_{j -/+ 1} (y beyond the ends 0) by prefix
    composition of the affine maps, (f2 o f1)(y) = (c2 + P2 c1) + P2 P1 y,
    in log2(N) doubling rounds. P: (nl*nl, N, K) flattened blocks,
    c: (nl, N, K); the chain runs along axis 1."""
    N = c.shape[1]
    d = 1
    while d < N:
        if reverse:       # compose with the map d rows further on
            Pn, cn = P[:, d:], c[:, d:]
            P0, c0 = P[:, :-d], c[:, :-d]
            P = torch.cat([_mm(P0, Pn, nl), P[:, N - d:]], dim=1)
            c = torch.cat([c0 + _mv(P0, cn, nl), c[:, N - d:]], dim=1)
        else:             # compose with the map d rows back
            Pp, cp = P[:, :-d], c[:, :-d]
            P1, c1 = P[:, d:], c[:, d:]
            P = torch.cat([P[:, :d], _mm(P1, Pp, nl)], dim=1)
            c = torch.cat([c[:, :d], c1 + _mv(P1, cp, nl)], dim=1)
        d *= 2
    return c


_BLOCK = 128   # the blocked sweep's in-block length


def _blocked_sweep(P, c, nl, C):
    """y_j = c_j + P_j y_{j-1} in two levels: an in-block chain of length C
    batched over the N/C blocks (local prefixes yhat and prefix products
    Q), a chain over the blocks for the carries, and an elementwise
    reconstruction. P: (nl, nl, N, K), c: (nl, N, K)."""
    N, K = c.shape[1], c.shape[2]
    nb = N // C

    def blockify(x):   # (..., N, K) -> (C, ..., nb, K), in-block leading
        return torch.movedim(x.reshape(*x.shape[:-2], nb, C, K), -2, 0)

    Pb = blockify(P).reshape(C, nl * nl, nb, K)
    cb = blockify(c)
    Q = torch.eye(nl, dtype=c.dtype, device=c.device).reshape(
        nl * nl, 1, 1).expand(nl * nl, nb, K)
    y = torch.zeros((nl, nb, K), dtype=c.dtype, device=c.device)
    Qs, yhat = [], []
    for i in range(C):
        Q = _mm(Pb[i], Q, nl)
        y = cb[i] + _mv(Pb[i], y, nl)
        Qs.append(Q)
        yhat.append(y)
    carry = torch.zeros((nl, K), dtype=c.dtype, device=c.device)
    Yprev = [carry]
    for b in range(nb - 1):     # the carry INTO block b + 1 is Y_b
        carry = y[:, b] + _mv(Q[:, b], carry, nl)
        Yprev.append(carry)
    Yprev = torch.stack(Yprev, dim=1)                     # (nl, nb, K)
    out = torch.stack([yh + _mv(Qi, Yprev, nl)
                       for Qi, yh in zip(Qs, yhat)])      # (C, nl, nb, K)
    return torch.movedim(out, 0, 2).reshape(nl, N, K)


def solve_spectral_vary(data: VarySpectralData, q: torch.Tensor,
                        method: str = "auto") -> torch.Tensor:
    """psi = L^-1 q for q of shape (nl, N, N). method: "auto" or "scan"
    (the sequential sweeps, `fused_vary.sweep`), "blocked" or "assoc"
    (torch ops)."""
    a = data.a
    nl = q.shape[0]
    if data.fac is not None:
        X = ctdst.fdst_x(data.fac, q)
    else:
        X = torch.matmul(q, data.S.T)
    N = X.shape[1]
    if method == "auto":
        method = "scan"
    if method not in ("scan", "blocked", "assoc"):
        raise ValueError(f"method={method!r}: 'auto', 'scan', 'blocked' or "
                         "'assoc'")
    if method == "blocked":
        C = _BLOCK if (N % _BLOCK == 0 and N // _BLOCK >= 2) else N // 4
        if C < 1 or N % C:
            method = "scan"   # no block size divides this N
    if method == "blocked":
        P = -a * data.W
        c = torch.einsum("abyk,byk->ayk", data.W, X)
        Y = _blocked_sweep(P, c, nl, C)
        # backward psi_j = y_j + P_j psi_{j+1}: flip y into a forward chain
        Psi = _blocked_sweep(torch.flip(P, (2,)), torch.flip(Y, (1,)), nl, C)
        Psi = torch.flip(Psi, (1,))
    elif method == "assoc":
        c = torch.einsum("abyk,byk->ayk", data.W, X)
        P = (-a * data.W).reshape(nl * nl, *data.W.shape[2:])
        Y = _affine_chain(P, c, nl)
        Psi = _affine_chain(P, Y, nl, reverse=True)
    else:
        Psi = fused_vary.sweep(data.W, X.contiguous(), a)
    if data.fac is not None:
        return ctdst.ifdst_x(data.fac, Psi)
    return torch.matmul(Psi, data.S)
