"""The direct spectral solves of a sharded run (the port of
`msom_tpu.parallel.spectral_shard`).

The pencil decomposition on a rows decomposition (its pencil part,
:104-186), which keeps the unsharded step's transforms:

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

On a 2-D (my, mx) mesh (parallel/mesh.py), the basis-matmul solve
(`transform_sharded`, `solve_spectral_sharded`, :44-105): a transform along
a sharded axis is one local matmul with the rank's block of the (N, N)
basis, whose partial sums over the whole output axis one reduce-scatter
within the rank's mesh row or column adds up and cuts to the rank's block;
the inverse denominators are cut like the fields. It needs the matmul
basis (build_spectral with transform="matmul", the JAX package's
force_matmul): a fold or an FFT does not split so. Data built with
refine=True runs the bf16 + refinement solve there (:91-97): two passes,
bf16 on a CUDA float32 tile, and the residual between them with its ghost
ring from `halo.ghosted_sharded`; the pencil solve refuses it, as JAX's
asserts.

The y-profile solve of varRo on the mesh (`solve_vary_sharded`, an
explicit form of what the JAX package runs partitioned under GSPMD): the x
DST as `transform_sharded` on the x axis, one all_to_all within each mesh
column so that every rank holds whole y columns of its block of x-modes,
the block-Thomas sweeps on them (kernel KV on the card, fused_vary.sweep)
and the way back. Where the N / mx modes of a mesh column do not split in
my, they are padded with zero columns (zero inverses, zero data).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as td
import torch.nn.functional as F

from msom_tpu_torch.parallel import dist, halo
from msom_tpu_torch.parallel.mesh import Mesh
from msom_tpu_torch.solvers import ctdst, fused_vary, spectral, vary


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
    matmul basis or a fold (not the FFT forms, which do not split) and no
    refinement (the JAX package's pencil solve asserts it away, :148)."""
    if data.refine:
        raise ValueError("the pencil solve does not take refine")
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


def a2a_cols(a: torch.Tensor, group=None, size: int | None = None
             ) -> torch.Tensor:
    """Rows shard -> columns shard: (nl, n_loc, K) -> (nl, n_loc * W,
    K / W), rank r keeping the r-th block of the last axis with every row
    of the W ranks of `group` (of `size` ranks; by default the world). One
    all_to_all_single, which splits its dim 0: the blocks go first."""
    if size is None:
        if not dist.active():
            return a
        size = dist.world_size()
    elif size == 1:
        return a
    W = size
    nl, n, K = a.shape
    k = K // W
    send = a.reshape(nl, n, W, k).permute(2, 0, 1, 3).contiguous()
    recv = torch.empty_like(send)          # (W sources, nl, n, k)
    td.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 0, 2, 3).reshape(nl, W * n, k)


def a2a_rows(a: torch.Tensor, group=None, size: int | None = None
             ) -> torch.Tensor:
    """The inverse of a2a_cols: (nl, N, k) -> (nl, N / W, k * W)."""
    if size is None:
        if not dist.active():
            return a
        size = dist.world_size()
    elif size == 1:
        return a
    W = size
    nl, N, k = a.shape
    n = N // W
    send = a.reshape(nl, W, n, k).permute(1, 0, 2, 3).contiguous()
    recv = torch.empty_like(send)          # (W sources, nl, n, k)
    td.all_to_all_single(recv, send, group=group)
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


# ---------------------------------------------------------------------------
# the 2-D mesh
# ---------------------------------------------------------------------------

def _reduce_scatter(partial: torch.Tensor, axis: int, group,
                    size: int) -> torch.Tensor:
    """The sum of every rank's `partial` over `group` (of `size` ranks),
    cut along `axis` into `size` blocks of which this rank keeps its own
    (its place in the group): one reduce-scatter."""
    if size == 1:
        return partial
    x = partial.movedim(axis, 0).contiguous()   # block i: rows i n ...
    out = torch.empty((x.shape[0] // size,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    # torch 2.13 names the call reduce_scatter_single and deprecates
    # reduce_scatter_tensor (a FutureWarning); earlier releases have only
    # reduce_scatter_tensor
    rs = getattr(td, "reduce_scatter_single", None) or \
        td.reduce_scatter_tensor
    rs(out, x, group=group)
    return out.movedim(0, axis).contiguous()


def _axis_transform(a, T, axis: int, inverse: bool, mesh: Mesh,
                    mm=torch.matmul):
    """One axis of transform_sharded: the local product mm with the
    rank's block of T, then the reduce-scatter over that axis's group."""
    if axis == -2:
        n, pos, group, size = a.shape[-2], mesh.yi, mesh.col, mesh.my
        blk = slice(pos * n, (pos + 1) * n)
        partial = mm(T[blk, :].T if inverse else T[:, blk], a)
    else:
        n, pos, group, size = a.shape[-1], mesh.xi, mesh.row, mesh.mx
        blk = slice(pos * n, (pos + 1) * n)
        partial = mm(a, T[blk, :] if inverse else T[:, blk].T)
    return _reduce_scatter(partial, axis, group, size)


def transform_sharded(a: torch.Tensor, T: torch.Tensor, *, inverse: bool,
                      mesh: Mesh, axes=(-2, -1), mm=torch.matmul
                      ) -> torch.Tensor:
    """The 2-D orthogonal transform of this rank's (..., ny_l, nx_l) tile
    (spectral_shard.py:44-73): forward T a T^T, inverse T^T a T, with T the
    whole (N, N) basis; along each of `axes` one local product mm(., .)
    with the rank's block of T and one reduce-scatter, the output cut like
    the input (in mode order)."""
    for axis in axes:
        a = _axis_transform(a, T, axis, inverse, mesh, mm)
    return a


@dataclasses.dataclass(frozen=True)
class MeshSpectralData:
    """One rank's part of the basis-matmul solve on a mesh: the basis
    whole, the inverse denominators of the rank's tile of modes; with
    `refine`, what the refinement's residual reads (iBu, delta, periodic)
    and the bf16 basis of its passes."""
    inv_den: torch.Tensor         # (nl, N / my, N / mx)
    l2m: torch.Tensor | None
    m2l: torch.Tensor | None
    S: torch.Tensor               # (N, N) DST-II or real Fourier basis
    mesh: Mesh
    refine: bool = False
    iBu: torch.Tensor | None = None
    delta: float = 0.0
    periodic: bool = False
    Sb: torch.Tensor | None = None


def mesh_data(data: spectral.SpectralData, mesh: Mesh) -> MeshSpectralData:
    """This rank's MeshSpectralData of a whole solve's data, which must
    have the matmul basis (build_spectral(transform="matmul"))."""
    if data.S is None or data.fac is not None:
        raise ValueError("the sharded spectral solve needs the matmul basis "
                         "(build_spectral(transform='matmul'))")
    N = data.S.shape[0]
    if N % mesh.my or N % mesh.mx:
        raise ValueError(f"the sharded spectral solve cuts N = {N} on a "
                         f"{mesh.my} x {mesh.mx} mesh")
    rows, cols = mesh.tile(N, N)
    return MeshSpectralData(
        inv_den=data.inv_den[:, rows, cols].contiguous(), l2m=data.l2m,
        m2l=data.m2l, S=data.S, mesh=mesh, refine=data.refine, iBu=data.iBu,
        delta=data.delta, periodic=data.periodic, Sb=data.Sb)


def build_matmul(cfg, strl, *, device) -> spectral.SpectralData:
    """The whole solve's data with the matmul basis (the DST-II, or the
    real Fourier basis when periodic) for a configuration whose unsharded
    solve has a form that does not split (the FFT, K7's fused_mm, or on a
    mesh the fold): the JAX package's sharded_cfg transform override and
    force_matmul. It builds no refinement: JAX's sharded configuration
    never sets it."""
    s_prof = None if strl is None else \
        strl.double().cpu().numpy()[:, 0, 0]
    return spectral.build_spectral(
        nl=cfg.nl, N=cfg.N, L0=cfg.L0, dh=np.asarray(cfg.dh[:cfg.nl]),
        s_profile=s_prof, periodic=cfg.sbc == -1,
        dtype=getattr(torch, cfg.dtype), transform="matmul", device=device)


def solve_spectral_sharded(data: MeshSpectralData,
                           q: torch.Tensor) -> torch.Tensor:
    """psi = L^-1 q of this rank's (nl, ny_l, nx_l) tile of q; the ranks
    call it together (spectral_shard.py:76-105). With `refine`, the bf16 +
    refinement solve: a pass (spectral.pass_product: bf16 on a CUDA
    float32 tile), the residual with its ghosts from the halo exchange,
    and a second pass on it."""
    mesh = data.mesh
    qm = q if data.l2m is None else torch.einsum("ml,lyx->myx", data.l2m, q)

    def one_solve(rhs, S, mm=torch.matmul):
        Q = transform_sharded(rhs, S, inverse=False, mesh=mesh, mm=mm)
        return transform_sharded(Q * data.inv_den, S, inverse=True,
                                 mesh=mesh, mm=mm)

    if data.refine:
        S, mm = spectral.pass_product(data, qm)
        pm = one_solve(qm, S, mm)
        r = spectral.modal_residual(
            data, qm, pm,
            ghost_fn=lambda f, bc: halo.ghosted_sharded(f, bc, mesh))
        pm = pm + one_solve(r, S, mm)
    else:
        pm = one_solve(qm, data.S)
    return pm if data.m2l is None else torch.einsum("lm,myx->lyx", data.m2l,
                                                    pm)


@dataclasses.dataclass(frozen=True)
class MeshVaryData:
    """One rank's part of the y-profile solve on a mesh: the x basis whole,
    the block inverses of the rank's `kb` x-modes (zero columns past the
    mesh column's N / mx), whole in y."""
    W: torch.Tensor               # (nl, nl, N, kb)
    S: torch.Tensor               # (N, N) DST-II basis
    a: float
    kb: int
    mesh: Mesh


def vary_data(data: vary.VarySpectralData, mesh: Mesh) -> MeshVaryData:
    """This rank's MeshVaryData of a whole y-profile solve's data, which
    must have the DST basis (build_spectral_vary(transform="matmul")). The
    rank (yi, xi) takes the x-modes xi N/mx + yi kb + [0, kb), kb =
    ceil(N / mx / my)."""
    if data.S is None:
        raise ValueError("the sharded y-profile solve needs the DST basis "
                         "(build_spectral_vary(transform='matmul'))")
    N = data.S.shape[0]
    if N % mesh.my or N % mesh.mx:
        raise ValueError(f"the sharded y-profile solve cuts N = {N} on a "
                         f"{mesh.my} x {mesh.mx} mesh")
    kx = N // mesh.mx
    kb = -(-kx // mesh.my)
    lo = mesh.xi * kx + mesh.yi * kb
    hi = min(lo + kb, (mesh.xi + 1) * kx)
    W = F.pad(data.W[..., lo:max(lo, hi)], (0, kb - max(0, hi - lo)))
    return MeshVaryData(W=W.contiguous(), S=data.S, a=data.a, kb=kb,
                        mesh=mesh)


def build_vary_matmul(cfg, spec: vary.VarySpectralData, strl, idh0, idh1, *,
                      device) -> vary.VarySpectralData:
    """The whole y-profile solve's data with the DST basis: `spec` where
    it has it, else rebuilt with transform="matmul"."""
    if spec.S is not None:
        return spec
    return vary.build_spectral_vary(
        nl=cfg.nl, N=cfg.N, L0=cfg.L0,
        s_prof=strl.double().cpu().numpy()[..., 0], idh0=idh0, idh1=idh1,
        dtype=getattr(torch, cfg.dtype), transform="matmul", device=device)


def solve_vary_sharded(data: MeshVaryData, q: torch.Tensor) -> torch.Tensor:
    """psi = L^-1 q of this rank's (nl, ny_l, nx_l) tile of q with a
    stratification that varies in y (vary.solve_spectral_vary on the
    mesh); the ranks call it together."""
    mesh = data.mesh
    X = _axis_transform(q, data.S, -1, False, mesh)      # (nl, ny_l, kx)
    kx = X.shape[-1]
    X = F.pad(X, (0, mesh.my * data.kb - kx))
    Xc = a2a_cols(X, mesh.col, mesh.my)                 # (nl, N, kb)
    Psi = fused_vary.sweep(data.W, Xc.contiguous(), data.a)
    Psi = a2a_rows(Psi, mesh.col, mesh.my)[..., :kx]    # (nl, ny_l, kx)
    return _axis_transform(Psi, data.S, -1, True, mesh)
