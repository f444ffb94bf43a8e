"""Geometric multigrid for the elliptic inversions (the port of
`msom_tpu.solvers.mg`).

* layered Helmholtz  L(a) = lap(a) + Gamma(a) + lam*a = b  per column with
  Neumann vertical BCs: the msqg PV inversion (msqg/poisson_layer.h; a
  tridiagonal coupling in the vertical);
* scalar Poisson/Helmholtz (nl = 1; the modal-inversion path, Basilisk
  poisson.h semantics);
* mspg's barotropic vorticity solver `solve_bt` (mspg/pg.h:207-349,
  elliptic.h): face coefficients, a first-order beta term and pseudo-SOR
  red-black point relaxation, as torch ops on either device.

The cycle is Basilisk's `mg_cycle`/`mg_solve` (mspg/elliptic.h:43-220): the
fine residual is restricted to every level (4-cell average), the correction
is swept from the coarsest level to the finest (zero, relax, bilinear
prolongation, relax, ...), added, and cycles repeat with an adaptive
relaxation count (aiming at a 1.2-10x residual reduction a cycle) until the
max-norm residual is under the tolerance or NITERMAX = 100. The smoother is
red-black vertical-line relaxation: each colour solves its columns' vertical
tridiagonals exactly with the horizontal neighbours frozen.

Routing is data, decided when the levels are built: a level whose
coefficients vary in y only carries y-profiles, and with Dirichlet or
Neumann walls its relaxations and residuals go to `fused_mg.relax` and
`fused_mg.residual_norm` (the Hopper kernels on a CUDA tensor, their plain
versions on a CPU tensor). A level without profiles (coefficients that vary
in x) and every periodic solve run the same arithmetic as torch ops on
either device. The restriction, the prolongation and `a + da` are torch
ops.

The cycle loop depends on the data, so it is a Python loop: the residual
norm comes to the host once a cycle (and once for the initial residual),
and `MGStats` holds host numbers.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from msom_tpu_torch.ops import tridiag
from msom_tpu_torch.ops.bc import BC, pad
from msom_tpu_torch.ops.ghost import ghosted
from msom_tpu_torch.ops.stencil import shift
from msom_tpu_torch.solvers import fused_mg

NITERMAX = 100


class MGStats(NamedTuple):
    iters: int        # cycles performed
    resb: float       # residual max-norm before
    resa: float       # residual max-norm after
    nrelax: int       # final relaxation count


def restrict_cell(a: torch.Tensor) -> torch.Tensor:
    """4-child average (Basilisk `restriction`), last two axes halved."""
    ny, nx = a.shape[-2:]
    out = F.avg_pool2d(a.reshape(1, -1, ny, nx), 2)
    return out.reshape(*a.shape[:-2], ny // 2, nx // 2)


def prolong_bilinear(c: torch.Tensor, bc: BC) -> torch.Tensor:
    """Basilisk `bilinear` prolongation: child = (9*parent + 3*nx + 3*ny +
    nxy)/16 with the neighbours toward the child's quadrant; coarse ghosts
    filled with the level BC (x before y, so corner ghosts compose
    sign_y o sign_x)."""
    return prolong_padded(pad(c, bc))


def prolong_padded(P: torch.Tensor) -> torch.Tensor:
    """`prolong_bilinear` of a coarse field given with its ghost ring
    (..., m+2, m'+2): each quadrant is computed at the coarse size and
    written into its stride-2 slots. A sharded level passes its tile's
    halo-exchanged ring (parallel/shard_mg.py)."""
    c = P[..., 1:-1, 1:-1]
    my, mx = c.shape[-2:]
    C9 = 9 * c
    # 3 * the west/east and south/north neighbours, and the four diagonals
    X3 = (3 * P[..., 1:-1, :-2], 3 * P[..., 1:-1, 2:])
    Y3 = (3 * P[..., :-2, 1:-1], 3 * P[..., 2:, 1:-1])
    rows = (slice(0, my), slice(2, my + 2))
    cols = (slice(0, mx), slice(2, mx + 2))
    out = c.new_empty(*c.shape[:-2], 2 * my, 2 * mx)
    for jy in (0, 1):
        for jx in (0, 1):
            out[..., jy::2, jx::2] = (C9 + X3[jx] + Y3[jy]
                                      + P[..., rows[jy], cols[jx]]) / 16.0
    return out


def _y_profile(a: torch.Tensor | None) -> torch.Tensor | None:
    """(k, n, n) or (k, n, 1) field -> contiguous (k, n) y-profile if it is
    constant along x, else None."""
    if a is None or a.ndim != 3:
        return None
    if a.shape[-1] != 1 and not torch.equal(
            a, a[..., :1].expand_as(a)):
        return None
    return a[..., 0].contiguous()


def _collapse(a: torch.Tensor | None) -> torch.Tensor | None:
    """A field that is constant along x as (k, n, 1), any other as it is."""
    p = _y_profile(a)
    return a if p is None else p[..., None]


_BC_SIGN = {BC.DIRICHLET: -1.0, BC.NEUMANN: 1.0}


@dataclasses.dataclass(frozen=True)
class _Level:
    """One level's precomputed data. The coefficient fields are (k, n, n),
    or (k, n, 1) where they are constant along x; then `sw` and `rp` hold
    their (k, n) y-profiles for the fused kernels."""
    delta: float
    s: torch.Tensor | None      # (nl-1, n, .) stretching at this level
    lam: torch.Tensor | None    # (nl, n, .) Helmholtz term, or None
    t0: torch.Tensor            # (nl, n, .) lower diagonal (0 for nl == 1)
    cp: torch.Tensor            # Thomas factors
    im: torch.Tensor
    red: torch.Tensor           # bool (n, n) checkerboard
    sw: fused_mg.SweepProfiles | None = None
    rp: fused_mg.ResidualProfiles | None = None


def build_layered_coeffs(*, nl: int, N: int, L0: float,
                         s: torch.Tensor | None = None,
                         idh0=None, idh1=None,
                         lam: torch.Tensor | None = None,
                         dtype=torch.float32, minlevel: int = 1,
                         device="cuda"):
    """Per-level coefficients and Thomas factors for solve_layered, made
    once at model set-up (the coefficients do not change in time;
    msqg/poisson_layer.h:281-284 restricts them every solve). `s` is
    (nl-1, N, N) or (nl-1, N, 1), `lam` (nl, N, N) or (nl, N, 1); the
    levels live on their device, or on `device` without either."""
    depth = int(round(np.log2(N)))
    idh0 = np.zeros(nl) if idh0 is None else idh0
    idh1 = np.zeros(nl) if idh1 is None else idh1
    return _make_levels(nl, depth, L0, s, idh0, idh1, lam, dtype, minlevel,
                        device=device)


def _restrict_coeff(a: torch.Tensor) -> torch.Tensor:
    """restrict_cell of a coefficient field in either form."""
    if a.shape[-1] == 1:
        return restrict_cell(a.expand(-1, -1, 2))
    return restrict_cell(a)


def _build_level(nl: int, n: int, delta: float, s_l, lam_l, idh0, idh1,
                 dtype, device) -> _Level:
    """One level from its coefficient fields ((k, n, n), or (k, n, 1) where
    constant along x): the line system's diagonals, their Thomas factors,
    and the y-profiles where every coefficient is one."""
    d2 = delta * delta
    if nl > 1 and s_l is not None:
        zero = torch.zeros((1,) + tuple(s_l.shape[1:]), dtype=dtype,
                           device=device)
        i0 = torch.as_tensor(idh0[1:], dtype=dtype,
                             device=device).reshape(-1, 1, 1)
        i1 = torch.as_tensor(idh1[:-1], dtype=dtype,
                             device=device).reshape(-1, 1, 1)
        t0 = torch.cat([zero, -d2 * s_l * i0])
        t2 = torch.cat([-d2 * s_l * i1, zero])
    else:
        # no vertical coupling: layers (or modes) are independent and the
        # line solve degenerates to a diagonal
        t0 = torch.zeros((nl, n, 1), dtype=dtype, device=device)
        t2 = torch.zeros((nl, n, 1), dtype=dtype, device=device)
    t1 = 4.0 - t0 - t2
    if lam_l is not None:
        t1 = t1 - d2 * lam_l
    cp, im = tridiag.factor(t0, t1, t2)
    sw = rp = None
    if all(c is None or c.shape[-1] == 1 for c in (s_l, lam_l, t0, cp, im)):
        sw = fused_mg.SweepProfiles(t0=_y_profile(t0), cp=_y_profile(cp),
                                    im=_y_profile(im))
        rp = fused_mg.ResidualProfiles(s=_y_profile(s_l),
                                       lam=_y_profile(lam_l))
    return _Level(delta=delta, s=s_l, lam=lam_l, t0=t0, cp=cp, im=im,
                  red=fused_mg.checkerboard(n, n, device), sw=sw, rp=rp)


def _make_levels(nl, depth, L0, s, idh0, idh1, lam, dtype, minlevel=1, *,
                 device):
    """List of _Level, finest first, on the device of `s` or `lam`, or on
    `device` without either."""
    idh0 = np.asarray(idh0, np.float64)
    idh1 = np.asarray(idh1, np.float64)
    for field in (s, lam):
        if field is not None:
            device = field.device
    device = torch.device(device)
    levels = []
    s_l, lam_l = _collapse(s), _collapse(lam)
    for lev in range(depth, minlevel - 1, -1):
        n = 2 ** lev
        levels.append(_build_level(nl, n, L0 / n, s_l, lam_l, idh0, idh1,
                                   dtype, device))
        if s_l is not None:
            s_l = _restrict_coeff(s_l)
        if lam_l is not None:
            lam_l = _restrict_coeff(lam_l)
    return levels


def _residual_layered(a, b, lvl: _Level, bc: BC, idh0, idh1):
    """(res, max|res|), res = b - L(a). msqg/poisson_layer.h:157-258."""
    if lvl.rp is not None and bc in _BC_SIGN:
        sign = _BC_SIGN[bc]
        return fused_mg.residual_norm(a, b, lvl.rp, delta=lvl.delta,
                                      idh0=idh0, idh1=idh1, sign_x=sign,
                                      sign_y=sign)
    return fused_mg.residual_plain(ghosted(a, bc), b, lvl.s, lvl.lam,
                                   lvl.delta, idh0, idh1)


def _relax_layered(da, res, lvl: _Level, nrelax: int, bc: BC):
    """nrelax sweeps of red-black vertical-line relaxation."""
    d2 = lvl.delta * lvl.delta
    if lvl.sw is not None and bc in _BC_SIGN:
        sign = _BC_SIGN[bc]
        return fused_mg.relax(da, res, lvl.sw, nrelax=nrelax, d2=d2,
                              sign_x=sign, sign_y=sign)
    for _ in range(nrelax):
        for mask in (lvl.red, ~lvl.red):
            da = fused_mg.relax_color(ghosted(da, bc), res, lvl.t0, lvl.cp,
                                      lvl.im, mask, d2)
    return da


def solve_layered(a0: torch.Tensor, b: torch.Tensor, *, L0: float,
                  s: torch.Tensor | None = None,
                  idh0=None, idh1=None,
                  lam: torch.Tensor | None = None,
                  bc: BC = BC.DIRICHLET,
                  tolerance: float = 1e-3,
                  nrelax0: int = 4,
                  minlevel: int = 1,
                  nitermax: int = NITERMAX,
                  levels: Sequence[_Level] | None = None):
    """Solve lap(a) + Gamma(a) + lam*a = b, warm-started from a0.

    a0, b: (nl, N, N). Returns (a, MGStats). The semantics of poisson_layer
    (msqg/poisson_layer.h:263-306) around mg_solve (mspg/elliptic.h:125-
    220): max-norm tolerance, at least one cycle, adaptive nrelax in
    [2, 100]."""
    nl, N, _ = a0.shape
    depth = int(round(np.log2(N)))
    if levels is None:
        levels = _make_levels(nl, depth, L0, s, idh0, idh1, lam, a0.dtype,
                              minlevel, device=a0.device)
    nlev = len(levels)  # levels[0] finest ... levels[-1] coarsest

    idh0 = np.zeros(nl) if idh0 is None else idh0
    idh1 = np.zeros(nl) if idh1 is None else idh1

    def cycle(a, res, nrelax):
        # restrict the residual down the hierarchy
        res_pyramid = [res]
        for _ in range(nlev - 1):
            res_pyramid.append(restrict_cell(res_pyramid[-1]))
        # coarsest-to-finest correction sweep
        da = torch.zeros_like(res_pyramid[-1])
        for k in range(nlev - 1, -1, -1):
            if k < nlev - 1:
                da = prolong_bilinear(da, bc)
            da = _relax_layered(da, res_pyramid[k], levels[k], nrelax, bc)
        return a + da

    a = a0
    res, maxres = _residual_layered(a, b, levels[0], bc, idh0, idh1)
    resb = resa = maxres.item()          # the residual norm, on the host
    nrelax, iters = nrelax0, 0
    while iters < nitermax and (iters < 1 or resa > tolerance):
        a = cycle(a, res, nrelax)
        res, maxres = _residual_layered(a, b, levels[0], bc, idh0, idh1)
        resa_new = maxres.item()         # one device-to-host read a cycle
        ratio = resa / max(resa_new, 1e-300)
        if resa_new > tolerance and ratio < 1.2 and nrelax < 100:
            nrelax += 1
        if resa_new > tolerance and ratio > 10.0 and nrelax > 2:
            nrelax -= 1
        resa = resa_new
        iters += 1
    return a, MGStats(iters=iters, resb=resb, resa=resa, nrelax=nrelax)


def solve_poisson(a0: torch.Tensor, b: torch.Tensor, *, L0: float,
                  lam: torch.Tensor | None = None, bc: BC = BC.DIRICHLET,
                  tolerance: float = 1e-3, **kw):
    """Scalar Helmholtz lap(a) + lam*a = b on (N, N) arrays (Basilisk
    poisson() semantics; the modal inversion msqg/qg.h:136-141)."""
    a, st = solve_layered(a0[None], b[None], L0=L0,
                          lam=None if lam is None else lam[None],
                          bc=bc, tolerance=tolerance, **kw)
    return a[0], st


# ---------------------------------------------------------------------------
# mspg barotropic vorticity solver (pseudo-SOR, first-order beta term)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _BtLevel:
    delta: float
    ax: torch.Tensor   # (ny, nx+1) face alpha x
    ay: torch.Tensor   # (ny+1, nx) face alpha y
    bx: torch.Tensor   # (ny, nx) cell beta.x
    by: torch.Tensor   # (ny, nx) cell beta.y
    red: torch.Tensor  # bool (ny, nx) checkerboard


def restrict_face_x(ax: torch.Tensor) -> torch.Tensor:
    """Coarse x-face = mean of the two fine x-faces it contains."""
    return 0.5 * (ax[..., ::2, ::2] + ax[..., 1::2, ::2])


def restrict_face_y(ay: torch.Tensor) -> torch.Tensor:
    return 0.5 * (ay[..., ::2, ::2] + ay[..., ::2, 1::2])


def _bt_levels(depth, L0, ax, ay, bx, by, minlevel=1):
    """The bt solver's levels, finest first, on the coefficients' device."""
    levels = []
    for lev in range(depth, minlevel - 1, -1):
        n = 2 ** lev
        levels.append(_BtLevel(delta=L0 / n, ax=ax, ay=ay, bx=bx, by=by,
                               red=fused_mg.checkerboard(n, n, ax.device)))
        ax, ay = restrict_face_x(ax), restrict_face_y(ay)
        bx, by = restrict_cell(bx), restrict_cell(by)
    return levels


def _bt_apply(a, lvl: _BtLevel, bc: BC, pad_fn=None):
    """The -L(a) part of residual_bt (mspg/pg.h:218-257, the non-TREE
    branch): what is added to b in the residual. `pad_fn` overrides the
    ghost fill: the hook for mspg's circulation BC, which the reference
    applies by rewriting ghosts after each cycle (elliptic.h:97) and which
    here enters the converged solution through the residual."""
    P = pad_fn(a) if pad_fn is not None else pad(a, bc)
    aC = shift(P, 0, 0)
    aE, aW = shift(P, 0, 1), shift(P, 0, -1)
    aN, aS = shift(P, 1, 0), shift(P, -1, 0)
    d = lvl.delta
    axl, axr = lvl.ax[..., :, :-1], lvl.ax[..., :, 1:]
    ayb, ayt = lvl.ay[..., :-1, :], lvl.ay[..., 1:, :]
    out = ((axr + axl) * aC - axr * aE - axl * aW) / (d * d)
    out = out + ((ayt + ayb) * aC - ayt * aN - ayb * aS) / (d * d)
    # f.x = -1: res += -beta.y*0.5*(aE-aW)/d; f.y = +1: res +=
    # beta.x*0.5*(aN-aS)/d
    out = out + -lvl.by * 0.5 * (aE - aW) / d
    out = out + lvl.bx * 0.5 * (aN - aS) / d
    return out


def _bt_relax(da, res, lvl: _BtLevel, nrelax: int, omega: float, bc: BC):
    """nrelax sweeps of pseudo-SOR red-black point relaxation
    (mspg/pg.h:260-318): c = (1 - omega) c + omega n/d."""
    d = lvl.delta
    axl, axr = lvl.ax[..., :, :-1], lvl.ax[..., :, 1:]
    ayb, ayt = lvl.ay[..., :-1, :], lvl.ay[..., 1:, :]
    den = axr + axl + ayt + ayb

    def one_color(da, mask):
        P = pad(da, bc)
        aE, aW = shift(P, 0, 1), shift(P, 0, -1)
        aN, aS = shift(P, 1, 0), shift(P, -1, 0)
        n = -d * d * res + axr * aE + axl * aW + ayt * aN + ayb * aS
        n = n - -lvl.by * 0.5 * (aE - aW) * d   # f.x = -1, sign per relax_bt
        n = n - lvl.bx * 0.5 * (aN - aS) * d    # f.y = +1
        new = (1.0 - omega) * shift(P, 0, 0) + omega * n / den
        return torch.where(mask, new, da)

    for _ in range(nrelax):
        da = one_color(da, lvl.red)
        da = one_color(da, ~lvl.red)
    return da


def solve_bt(a0: torch.Tensor, b: torch.Tensor, *, L0: float,
             alpha_x: torch.Tensor, alpha_y: torch.Tensor,
             beta_x: torch.Tensor, beta_y: torch.Tensor,
             omega: float = 0.3, bc: BC = BC.DIRICHLET,
             tolerance: float = 1e-3, nrelax0: int = 4, minlevel: int = 1,
             nitermax: int = NITERMAX, pad_fn=None):
    """mspg's barotropic streamfunction solver (btsolver, mspg/pg.h:320-
    349): div(alpha grad a) + beta terms = b with pseudo-SOR relaxation,
    warm-started from a0 (N, N). The cycle is solve_layered's: at least one
    cycle, the max-norm residual read on the host once a cycle, nrelax
    adapted in [2, 100]. `pad_fn` fills the fine residual's ghosts (mspg's
    circulation BC). Returns (a, MGStats)."""
    N = a0.shape[-1]
    depth = int(round(np.log2(N)))
    levels = _bt_levels(depth, L0, alpha_x, alpha_y, beta_x, beta_y,
                        minlevel)
    nlev = len(levels)

    def residual(a):
        res = b + _bt_apply(a, levels[0], bc, pad_fn)
        return res, torch.max(torch.abs(res))

    def cycle(a, res, nrelax):
        pyr = [res]
        for _ in range(nlev - 1):
            pyr.append(restrict_cell(pyr[-1]))
        da = torch.zeros_like(pyr[-1])
        for k in range(nlev - 1, -1, -1):
            if k < nlev - 1:
                da = prolong_bilinear(da, bc)
            da = _bt_relax(da, pyr[k], levels[k], nrelax, omega, bc)
        return a + da

    a = a0
    res, maxres = residual(a)
    resb = resa = maxres.item()          # the residual norm, on the host
    nrelax, iters = nrelax0, 0
    while iters < nitermax and (iters < 1 or resa > tolerance):
        a = cycle(a, res, nrelax)
        res, maxres = residual(a)
        resa_new = maxres.item()         # one device-to-host read a cycle
        ratio = resa / max(resa_new, 1e-300)
        if resa_new > tolerance and ratio < 1.2 and nrelax < 100:
            nrelax += 1
        if resa_new > tolerance and ratio > 10.0 and nrelax > 2:
            nrelax -= 1
        resa = resa_new
        iters += 1
    return a, MGStats(iters=iters, resb=resb, resa=resa, nrelax=nrelax)
