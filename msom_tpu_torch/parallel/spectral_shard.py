"""The pencil decomposition of the direct spectral solve on a rows
decomposition (the port of `msom_tpu.parallel.spectral_shard`'s pencil
part, :104-186).

    x-transform (local, full rows) -> all_to_all (y becomes whole, the
    x-modes split) -> y-transform (local) -> * inv_den (the rank's block of
    x-modes) -> inverse y-transform -> all_to_all back -> inverse
    x-transform

Every transform runs on whole axes, the folded DST's stages or the
(N, N) basis (DST-II, or the real Fourier basis when periodic) as torch
matmuls, at 1/W of the whole solve's work; the only communication is two
all_to_all_single transposes a solve. A fold emits its modes in a permuted
order (solvers/ctdst.py): the split cuts that order into W contiguous
blocks, and rank r keeps the same block of the permuted inv_den, so the
two agree. The modal l2m/m2l products are local. N % W == 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as td

from msom_tpu_torch.parallel import dist
from msom_tpu_torch.solvers import ctdst, spectral


@dataclasses.dataclass(frozen=True)
class PencilData:
    """One rank's part of a spectral solve: the transforms whole, the
    inverse denominators of the rank's block of x-modes (the last axis of
    inv_den in the transform's mode order)."""
    inv_den: torch.Tensor         # (nl, N, N / W)
    l2m: torch.Tensor | None
    m2l: torch.Tensor | None
    S: torch.Tensor | None        # (N, N) basis, or
    fac: ctdst.FoldedDST | None   # the folded DST-II


def pencil_data(data: spectral.SpectralData, rank: int,
                world: int) -> PencilData:
    """Rank `rank`'s PencilData of a whole solve's data, which must have a
    matmul basis or a fold (not the FFT forms, which do not split)."""
    if data.S is None and data.fac is None:
        raise ValueError("the pencil solve needs a matmul basis or a fold")
    if isinstance(data.fac, ctdst.FoldedDST1):
        raise ValueError("the pencil solve takes the DST-II fold")
    K = data.inv_den.shape[-1]
    if K % world:
        raise ValueError(f"the pencil solve splits {K} modes in {world}")
    k = K // world
    return PencilData(
        inv_den=data.inv_den[..., rank * k:(rank + 1) * k].contiguous(),
        l2m=data.l2m, m2l=data.m2l, S=data.S, fac=data.fac)


def build_pencil(cfg, spec: spectral.SpectralData | None, strl, *,
                 device) -> spectral.SpectralData:
    """The whole solve's data for the pencil path: `spec` where it has a
    matmul basis or a fold (the unsharded step's own), else (the FFT forms,
    K7's fused_mm) the same solve rebuilt with the matmul basis, as the
    JAX package rebuilds it (parallel/step.py:147-166)."""
    if spec is not None and (spec.S is not None or spec.fac is not None) \
            and not spec.fused_mm:
        return spec
    s_prof = None if strl is None else \
        strl.double().cpu().numpy()[:, 0, 0]
    return spectral.build_spectral(
        nl=cfg.nl, N=cfg.N, L0=cfg.L0, dh=np.asarray(cfg.dh[:cfg.nl]),
        s_profile=s_prof, periodic=cfg.sbc == -1,
        dtype=getattr(torch, cfg.dtype), transform="matmul", device=device)


def a2a_cols(a: torch.Tensor) -> torch.Tensor:
    """Rows shard -> columns shard: (nl, n_loc, N) -> (nl, N, N / W), rank
    r keeping the r-th block of the last axis with every row. One
    all_to_all_single, which splits its dim 0: the blocks go first."""
    if not dist.active():
        return a
    W = dist.world_size()
    nl, n, K = a.shape
    k = K // W
    send = a.reshape(nl, n, W, k).permute(2, 0, 1, 3).contiguous()
    recv = torch.empty_like(send)          # (W sources, nl, n, k)
    td.all_to_all_single(recv, send)
    return recv.permute(1, 0, 2, 3).reshape(nl, W * n, k)


def a2a_rows(a: torch.Tensor) -> torch.Tensor:
    """The inverse of a2a_cols: (nl, N, N / W) -> (nl, n_loc, N)."""
    if not dist.active():
        return a
    W = dist.world_size()
    nl, N, k = a.shape
    n = N // W
    send = a.reshape(nl, W, n, k).permute(1, 0, 2, 3).contiguous()
    recv = torch.empty_like(send)          # (W sources, nl, n, k)
    td.all_to_all_single(recv, send)
    return recv.permute(1, 2, 0, 3).reshape(nl, n, W * k)


def solve_spectral_pencil(data: PencilData, q: torch.Tensor) -> torch.Tensor:
    """psi = L^-1 q of this rank's (nl, n_loc, N) rows of q; the ranks call
    it together (spectral_shard.py:129-176)."""
    qm = q if data.l2m is None else torch.einsum("ml,lyx->myx", data.l2m, q)
    if data.fac is not None:
        f = data.fac
        Q = ctdst.fdst_y(f, a2a_cols(ctdst.fdst_x(f, qm)))
        pm = ctdst.ifdst_x(f, a2a_rows(ctdst.ifdst_y(f, Q * data.inv_den)))
    else:
        S = data.S
        Q = torch.matmul(S, a2a_cols(torch.matmul(qm, S.T)))
        pm = torch.matmul(a2a_rows(torch.matmul(S.T, Q * data.inv_den)), S)
    return pm if data.m2l is None else torch.einsum("lm,myx->lyx", data.m2l,
                                                    pm)
