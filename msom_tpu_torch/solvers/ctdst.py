"""Folded (Lee even/odd) matmul DST-II and DST-I (the port of the
FoldedDST and FoldedDST1 parts of `msom_tpu.solvers.ctdst`).

The orthonormal DST-II matrix S obeys S[k, N-1-i] = (-1)^k S[k, i], so with
e = (x + flip x)[:N/2] and o = (x - flip x)[:N/2]:
    y[even k] = S[0::2, :N/2] @ e      (dense block)
    y[odd  k] = S[1::2, :N/2] @ o      (recurse on the odd block)
Each level halves the odd block, cutting the flops of one (N, N) matmul to
0.5 / 0.375 / 0.344 of it at L = 1 / 2 / 3. The outputs come out in a
permuted modal order; `build_fold` returns the permutation, which the solve
applies to its diagonal denominator once at build time, and the inverse is
the exact adjoint chain on the permuted layout. The block matrices are
slices of the true orthonormal matrix, so inverse = transpose is inherited.
FoldedDST1 is the same recursion for the odd-length DST-I of the vertex
grid's N-1 interior nodes (the qg-node spectral inversion).

Here every block product is a `torch.matmul` (cuBLAS on the card, in full
f32 with TF32 off; the JAX package runs them as XLA einsums).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FoldedDST:
    """Per-level even-block matrices + the leaf block for one length N.

    Mes[l]: (N/2^(l+1), N/2^(l+1)) dense even-k block of level l;
    Mleaf: (N/2^L, N/2^L) remaining odd-chain block."""
    Mes: tuple
    Mleaf: torch.Tensor
    N: int
    L: int


def default_levels(N: int, min_leaf: int = 256) -> int:
    """Fold while the leaf stays >= min_leaf; at least one fold for any
    usable N (correct, if not profitable, at small N)."""
    L = 0
    n = N
    while n // 2 >= min_leaf and L < 8:
        n //= 2
        L += 1
    return max(L, 1) if N >= 32 else 0


def build_fold(N: int, dtype, device):
    """(FoldedDST, perm): perm[j] = the natural modal index k of output slot
    j. (None, None) where N is not a power of 2 >= 32 (no fold level)."""
    from msom_tpu_torch.solvers.spectral import dst_matrix
    L = default_levels(N) if N & (N - 1) == 0 else 0
    if L == 0:
        return None, None
    M = dst_matrix(N)
    Mes = []
    perm_parts = []
    rows = np.arange(N)
    for _ in range(L):
        n = M.shape[1]
        Mes.append(torch.as_tensor(M[0::2, :n // 2], dtype=dtype).to(device))
        perm_parts.append(rows[0::2])
        M = np.ascontiguousarray(M[1::2, :n // 2])
        rows = rows[1::2]
    perm = np.concatenate(perm_parts + [rows])
    return FoldedDST(Mes=tuple(Mes),
                     Mleaf=torch.as_tensor(M, dtype=dtype).to(device),
                     N=N, L=L), perm


def _sizes(f: FoldedDST):
    return [f.N >> (l + 1) for l in range(f.L)] + [f.N >> f.L]


def fdst_x(f: FoldedDST, x: torch.Tensor) -> torch.Tensor:
    """Forward DST-II along the LAST axis, permuted modal output order."""
    parts = []
    cur = x
    for Me in f.Mes:
        n = cur.shape[-1]
        xf = torch.flip(cur, (-1,))
        e = (cur + xf)[..., :n // 2]
        o = (cur - xf)[..., :n // 2]
        parts.append(torch.matmul(e, Me.T))
        cur = o
    parts.append(torch.matmul(cur, f.Mleaf.T))
    return torch.cat(parts, dim=-1)


def ifdst_x(f: FoldedDST, y: torch.Tensor) -> torch.Tensor:
    """Inverse (= adjoint) along the LAST axis from the permuted order."""
    parts = torch.split(y, _sizes(f), dim=-1)
    cur = torch.matmul(parts[-1], f.Mleaf)
    for l in reversed(range(f.L)):
        ec = torch.matmul(parts[l], f.Mes[l])
        cur = torch.cat([ec + cur, torch.flip(ec - cur, (-1,))], dim=-1)
    return cur


def fdst_y(f: FoldedDST, x: torch.Tensor) -> torch.Tensor:
    """Forward DST-II along axis -2 (no explicit transpose)."""
    parts = []
    cur = x
    for Me in f.Mes:
        n = cur.shape[-2]
        xf = torch.flip(cur, (-2,))
        e = (cur + xf)[..., :n // 2, :]
        o = (cur - xf)[..., :n // 2, :]
        parts.append(torch.matmul(Me, e))
        cur = o
    parts.append(torch.matmul(f.Mleaf, cur))
    return torch.cat(parts, dim=-2)


def ifdst_y(f: FoldedDST, y: torch.Tensor) -> torch.Tensor:
    parts = torch.split(y, _sizes(f), dim=-2)
    cur = torch.matmul(f.Mleaf.T, parts[-1])
    for l in reversed(range(f.L)):
        ec = torch.matmul(f.Mes[l].T, parts[l])
        cur = torch.cat([ec + cur, torch.flip(ec - cur, (-2,))], dim=-2)
    return cur


# ---------------------------------------------------------------------------
# Folded DST-I (odd lengths N-1): the nodal (vertex) transform
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FoldedDST1:
    """Folded DST-I (spectral.dst1_matrix): the same Lee even/odd recursion
    as FoldedDST over the odd lengths m = N-1. Each fold of an odd m has a
    middle column that belongs to the even part alone (the odd rows'
    middle coefficients sin(pi (k+1) / 2) are zero at even k+1), so the
    even blocks are (ceil(m/2), m//2 + 1) and the odd chain keeps folding
    odd lengths. Output order permuted; build_fold1 returns the
    permutation, applied to inv_den on both axes at build time."""
    Mes: tuple
    Mleaf: torch.Tensor
    N: int
    L: int


def build_fold1(N: int, dtype, device, L: int | None = None):
    """(FoldedDST1, perm) for the (N-1)-point DST-I; (None, None) unless N
    is a power of 2 >= 32 (an even non-power-of-2 N would walk the odd
    chain into even sub-lengths)."""
    from msom_tpu_torch.solvers.spectral import dst1_matrix
    if N < 32 or N & (N - 1):
        return None, None
    if L is None:
        L = default_levels(N)
    if L == 0:
        return None, None
    M = dst1_matrix(N)
    Mes = []
    perm_parts = []
    rows = np.arange(N - 1)
    for _ in range(L):
        m = M.shape[1]
        h = m // 2
        if m % 2 == 1:
            # the odd rows' middle-column coefficients are zero
            assert np.abs(M[1::2, h]).max() < 1e-10
            Mes.append(torch.as_tensor(M[0::2, :h + 1], dtype=dtype)
                       .to(device))
        else:
            Mes.append(torch.as_tensor(M[0::2, :h], dtype=dtype).to(device))
        perm_parts.append(rows[0::2])
        M = np.ascontiguousarray(M[1::2, :h])
        rows = rows[1::2]
    perm = np.concatenate(perm_parts + [rows])
    return FoldedDST1(Mes=tuple(Mes),
                      Mleaf=torch.as_tensor(M, dtype=dtype).to(device),
                      N=N, L=L), perm


def _widths1(f: FoldedDST1):
    """Per level (input width m, half h, m odd), walking the odd chain."""
    m = f.N - 1
    out = []
    for _ in range(f.L):
        h = m // 2
        out.append((m, h, m % 2 == 1))
        m = h
    return out


def fdst1_x(f: FoldedDST1, x: torch.Tensor) -> torch.Tensor:
    """Forward DST-I along the LAST axis, permuted modal output order."""
    parts = []
    cur = x
    for Me, (m, h, odd) in zip(f.Mes, _widths1(f)):
        xf = torch.flip(cur[..., h + (1 if odd else 0):], (-1,))
        e = cur[..., :h] + xf
        if odd:
            e = torch.cat([e, cur[..., h:h + 1]], dim=-1)
        o = cur[..., :h] - xf
        parts.append(torch.matmul(e, Me.T))
        cur = o
    parts.append(torch.matmul(cur, f.Mleaf.T))
    return torch.cat(parts, dim=-1)


def _sizes1(f: FoldedDST1):
    return [Me.shape[0] for Me in f.Mes] + [f.Mleaf.shape[0]]


def ifdst1_x(f: FoldedDST1, y: torch.Tensor) -> torch.Tensor:
    """Inverse (= adjoint) along the LAST axis from the permuted order."""
    widths = _widths1(f)
    parts = torch.split(y, _sizes1(f), dim=-1)
    cur = torch.matmul(parts[-1], f.Mleaf)
    for l in reversed(range(f.L)):
        ec = torch.matmul(parts[l], f.Mes[l])
        m, h, odd = widths[l]
        if odd:
            mid = ec[..., h:h + 1]
            ec = ec[..., :h]
            cur = torch.cat([ec + cur, mid, torch.flip(ec - cur, (-1,))],
                            dim=-1)
        else:
            cur = torch.cat([ec + cur, torch.flip(ec - cur, (-1,))], dim=-1)
    return cur


def fdst1_y(f: FoldedDST1, x: torch.Tensor) -> torch.Tensor:
    """Forward DST-I along axis -2 (no explicit transpose)."""
    parts = []
    cur = x
    for Me, (m, h, odd) in zip(f.Mes, _widths1(f)):
        xf = torch.flip(cur[..., h + (1 if odd else 0):, :], (-2,))
        e = cur[..., :h, :] + xf
        if odd:
            e = torch.cat([e, cur[..., h:h + 1, :]], dim=-2)
        o = cur[..., :h, :] - xf
        parts.append(torch.matmul(Me, e))
        cur = o
    parts.append(torch.matmul(f.Mleaf, cur))
    return torch.cat(parts, dim=-2)


def ifdst1_y(f: FoldedDST1, y: torch.Tensor) -> torch.Tensor:
    widths = _widths1(f)
    parts = torch.split(y, _sizes1(f), dim=-2)
    cur = torch.matmul(f.Mleaf.T, parts[-1])
    for l in reversed(range(f.L)):
        ec = torch.matmul(f.Mes[l].T, parts[l])
        m, h, odd = widths[l]
        if odd:
            mid = ec[..., h:h + 1, :]
            ec = ec[..., :h, :]
            cur = torch.cat([ec + cur, mid, torch.flip(ec - cur, (-2,))],
                            dim=-2)
        else:
            cur = torch.cat([ec + cur, torch.flip(ec - cur, (-2,))], dim=-2)
    return cur
