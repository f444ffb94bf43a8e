"""Vertex (nodal) multigrid, the vpoisson equivalent (the port of
`msom_tpu.solvers.vmg`).

Mirrors qg-node/nodal-poisson.h: a cycle computes the masked residual on the
finest vertex grid, restricts it down the hierarchy with the weighted
vertex restriction, zeroes the correction on the coarsest level, then
sweeps up relaxing and prolonging (refine_vert) and adds the correction;
cycles repeat to the max-norm tolerance (NITERMAX = 100, a fixed
nrelax = 5: the nodal solver has no adaptive nrelax).

The smoother is the masked red-black version of relax_baroclinic
(qg_baroclinic_ms.h:228-293): each column's vertical tridiagonal solved by
Thomas with the horizontal neighbours frozen, exact on each colour, and
relax_barotropic (qg_barotropic.h:57-76) as the nl = 1 case with the
-iRd2_low Helmholtz shift. Every sweep goes to `fused_vmg.vrb_sweep`: kernel
K6 on a CUDA tensor, on every level down to n = 3; its plain version on a
CPU tensor. The residual, the transfers and `a + da` are torch ops.

The cycle loop depends on the data, so it is a Python loop: the residual
norm comes to the host once a cycle (and once for the first residual), and
`MGStats` holds host numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from msom_tpu_torch.ops import tridiag, vertex
from msom_tpu_torch.ops.stretch import stretch
from msom_tpu_torch.solvers import fused_vmg
from msom_tpu_torch.solvers.fused_mg import checkerboard
from msom_tpu_torch.solvers.mg import MGStats

NITERMAX = 100
NRELAX = 5               # sweeps a level on the way up, fixed
STALL_RATIO_F32 = 0.9    # an f32 cycle must cut the residual by 10%


@dataclasses.dataclass(frozen=True)
class VLevel:
    """One level's data. t0, cp, im are full contiguous (nl, n, n) fields,
    as the sweep kernel reads them; the layout is checked once, here."""
    delta: float
    S2: torch.Tensor | None    # (nl-1, n, n) f^2/N^2 at the interfaces
    lam: float                 # iRd2_low Helmholtz coefficient (nl == 1)
    mask: torch.Tensor         # (n, n)
    t0: torch.Tensor
    cp: torch.Tensor
    im: torch.Tensor
    red: torch.Tensor          # bool (n, n), (row + column) even

    def __post_init__(self):
        fused_vmg.check_level(self)


def build_vlevels(*, nl: int, N: int, L0: float, S2=None, idh0=None,
                  idh1=None, iRd2_low: float = 0.0, mask=None,
                  dtype=torch.float32, device="cuda"):
    """Per-level data, finest first (n = N+1 down to 3). S2 is restricted
    by injection
    (S2.restriction = restriction_vert, qg_baroclinic_ms.h:424), the mask by
    the 16-point weighted restriction (qg.h:419) with a zero ring on every
    level. The levels live on the device of `mask` or `S2`, or on
    `device` without either.

    The line systems and their Thomas factors are formed in float64 and
    rounded to `dtype` once. On the coarse levels d2 S2 idh reaches 1e8
    (bench's stratification, delta = 50 at n = 3), and in float32 the
    elimination loses the Laplacian's diagonal 4 to cancellation: the JAX
    package, which factors in the working type, gets inf factors there and
    a NaN solve (ROADMAP.md queue 3). In float64 this is the JAX
    package's arithmetic."""
    for field in (mask, S2):
        if field is not None:
            device = field.device
    device = torch.device(device)
    depth = int(round(np.log2(N)))
    if 2 ** depth != N:
        raise ValueError(f"the vertex multigrid needs N a power of 2, got "
                         f"{N}")
    if mask is None:
        mask = vertex.default_mask(N, dtype, device)
    idh0 = np.zeros(max(nl, 1)) if idh0 is None else np.asarray(idh0)
    idh1 = np.zeros(max(nl, 1)) if idh1 is None else np.asarray(idh1)
    levels = []
    S2_l, mask_l = S2, mask
    f64 = dict(dtype=torch.float64, device=device)
    for lev in range(depth, 0, -1):
        n = 2 ** lev + 1
        delta = L0 / 2 ** lev
        d2 = delta * delta
        m = mask_l.to(torch.float64)
        if nl > 1 and S2_l is not None:
            s = S2_l.to(torch.float64)
            zero = torch.zeros((1, n, n), **f64)
            i0 = torch.as_tensor(idh0[1:], **f64).reshape(-1, 1, 1)
            i1 = torch.as_tensor(idh1[:-1], **f64).reshape(-1, 1, 1)
            t0 = torch.cat([zero, -d2 * s * m * i0])
            t2 = torch.cat([-d2 * s * m * i1, zero])
        else:
            t0 = torch.zeros((1, n, n), **f64)
            t2 = torch.zeros((1, n, n), **f64)
        t1 = 4.0 - t0 - t2 + d2 * iRd2_low
        cp, im = tridiag.factor(t0, t1, t2)
        full = (max(nl, 1), n, n)
        t0, cp, im = (a.expand(full).to(dtype).contiguous()
                      for a in (t0, cp, im))
        levels.append(VLevel(delta=delta, S2=S2_l, lam=iRd2_low, mask=mask_l,
                             t0=t0, cp=cp, im=im,
                             red=checkerboard(n, n, device)))
        if S2_l is not None:
            S2_l = vertex.vrestrict_inject(S2_l)
        mask_l = vertex.zero_ring_(vertex.vrestrict_weighted16(mask_l))
    return levels


def residual_v(a: torch.Tensor, b: torch.Tensor, lvl: VLevel, idh0, idh1):
    """(res, max|res|): the masked residual (residual_baroclinic,
    qg_baroclinic_ms.h:295-339, and residual_barotropic with the -iRd2_low
    term)."""
    res = b - vertex.vlap(a, lvl.delta)
    if lvl.S2 is not None:
        res = res - stretch(a, lvl.S2, idh0, idh1)
    if lvl.lam != 0.0:
        res = res + lvl.lam * a    # the operator includes -iRd2_low * a
    res = res * lvl.mask
    return res, res.abs().max()


def relax_v(da: torch.Tensor, res: torch.Tensor, lvl: VLevel,
            nrelax: int) -> torch.Tensor:
    """nrelax red-black masked vertical-line sweeps (K6 on a CUDA
    tensor)."""
    for _ in range(nrelax):
        da = fused_vmg.vrb_sweep(da, res, lvl)
    return da


def vpoisson(a0: torch.Tensor, b: torch.Tensor, *,
             levels: Sequence[VLevel], idh0, idh1, tolerance: float = 1e-5,
             nitermax: int = NITERMAX):
    """Solve the nodal PV inversion warm-started from a0; returns
    (a, MGStats).

    Besides the reference's absolute max-norm tolerance (nodal-poisson.h:
    119-134; TOLERANCE = 1e-5 assumes f64), an f32 solve stops when a cycle
    fails to cut the residual by 10% (STALL_RATIO_F32): in f32 at large N
    the residual floors at the roundoff of the operator (about 3e-5 at
    2048^2, above the reference tolerance), and without the cutoff every
    solve would spin all NITERMAX cycles at the floor. In f64 the cutoff is
    off. The first cycle always runs."""
    nlev = len(levels)
    stall_ratio = STALL_RATIO_F32 if b.element_size() <= 4 else float("inf")

    def cycle(a, res):
        pyr = [res]
        for _ in range(nlev - 1):
            pyr.append(vertex.vrestrict_weighted(pyr[-1]))
        da = torch.zeros_like(pyr[-1])
        for k in range(nlev - 1, -1, -1):
            if k < nlev - 1:
                da = vertex.zero_ring_(vertex.vprolong(da))
            da = relax_v(da, pyr[k], levels[k], NRELAX)
        return a + da

    a = a0
    res, maxres = residual_v(a, b, levels[0], idh0, idh1)
    resb = resa = maxres.item()          # the residual norm, on the host
    resp = torch.finfo(b.dtype).max / 4
    iters = 0
    while iters < nitermax and (iters < 1 or (
            resa > tolerance and resa <= stall_ratio * resp)):
        a = cycle(a, res)
        res, maxres = residual_v(a, b, levels[0], idh0, idh1)
        resp, resa = resa, maxres.item()  # one device-to-host read a cycle
        iters += 1
    return a, MGStats(iters=iters, resb=resb, resa=resa, nrelax=NRELAX)
