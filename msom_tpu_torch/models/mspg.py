"""Planetary-geostrophic large-scale ocean model, mspg (the port of
`msom_tpu.models.mspg`; reference mspg/pg.h + pg.c).

Buoyancy and momentum on nl sigma layers with a one-time barotropic
vorticity solve (`build_constants`: pseudo-SOR multigrid with the
perimeter circulation BC), flux-form 3-D advection with a diagnostic
vertical velocity, implicit vertical diffusion, explicit horizontal
diffusion, convective adjustment, implicit surface buoyancy relaxation,
Gent-McWilliams eddy-induced advection and the QG eddy buoyancy forcing
`b_forc`, stepped with msqg's predictor-corrector (`make_step`, dt from
`qg.dtnext`).

Layout: buoyancy b is (nl, N, N) (the reference's ghost layers 0 and nl+1,
vertbc pg.h:374-387, are applied functionally); face velocities are ux
(nl, N, N+1) and uy (nl, N+1, N); layer 0 is the surface, layer nl-1 the
bottom. The Coriolis parameter is the latitude y everywhere (the JAX
package's reading of the reference's face-rotated code, mspg.py:16-21).

The step is torch ops on the state's device and makes no host sync: the
CFL chain and the convective sweep stay 0-d or full tensors on the device.
At the reference's 64^2 x 30 the step is a few thousand small launches,
so the card is launch-bound there.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from msom_tpu_torch.models.qg import _torch_dtype, dtnext
from msom_tpu_torch.ops import tridiag
from msom_tpu_torch.ops.bc import BC, pad
from msom_tpu_torch.params import PGConfig
from msom_tpu_torch.solvers import mg


@dataclasses.dataclass
class PGState:
    b: torch.Tensor        # (nl, N, N) buoyancy, layer 0 = surface
    ux: torch.Tensor       # (nl, N, N+1) x-face velocity
    uy: torch.Tensor       # (nl, N+1, N) y-face velocity
    t: torch.Tensor        # 0-d model time
    dt_prev: torch.Tensor  # 0-d CFL controller smoothing state
    i: torch.Tensor        # 0-d int32 step counter
    b_me: torch.Tensor     # running means (comp_output, pg.c:179-203)
    ux_me: torch.Tensor
    uy_me: torch.Tensor
    nme: torch.Tensor      # 0-d int32 samples in the means


@dataclasses.dataclass(frozen=True)
class PGConstants:
    psibt: torch.Tensor          # (N, N) barotropic streamfunction
    ubtx: torch.Tensor           # (N, N+1) barotropic velocities
    ubty: torch.Tensor           # (N+1, N)
    b_surf: torch.Tensor         # (N, N) surface restoring profile
    b_forc: torch.Tensor | None  # (nl, N, N) QG eddy forcing
    kx_face: torch.Tensor        # (nl, N, N+1) kh*k at x-faces
    ky_face: torch.Tensor        # (nl, N+1, N)
    kv_prof: torch.Tensor        # (nl+1, N, N) kv*k at sigma faces sf[0..nl]
    yc: torch.Tensor             # (N, N) cell y
    yf: torch.Tensor             # (N+1, 1) y-face y
    sc: tuple                    # sigma centres
    sf: tuple                    # sigma faces
    bt_stats: mg.MGStats | None = None   # the bt solve's cycles, residual


class PGStepDiag(NamedTuple):
    dt: torch.Tensor


# ---------------------------------------------------------------------------
# circulation boundary condition (circ_bc, pg.h:78-163)
# ---------------------------------------------------------------------------

def perimeter_inverse(N: int, r: float, ys: float, L0: float, *,
                      dtype=torch.float64, device="cpu") -> torch.Tensor:
    """The (4N, 4N) inverse of circ_bc's perimeter system (sub- and
    super-diagonals -/+ y/(4r), unit diagonal, the path bottom L->R, right
    B->T, top R->L, left T->B), formed once in f64 on the host by the
    Thomas sweep (`tridiag.thomas_scan`) of the identity's columns: each
    later solve is one matrix-vector product instead of 4N dependent
    steps each way."""
    delta = L0 / N
    yc = ys + (torch.arange(N, dtype=torch.float64) + 0.5) * delta
    ypath = torch.cat([yc[:1].expand(N), yc, yc[-1:].expand(N), yc.flip(0)])
    ad = (-ypath / (4.0 * r))[:, None]
    minv = tridiag.thomas_scan(ad, torch.ones_like(ad), -ad,
                               torch.eye(4 * N, dtype=torch.float64))
    return minv.to(dtype=dtype, device=device)


def circ_bc_pad(psi: torch.Tensor, r: float, ys: float, L0: float,
                minv: torch.Tensor | None = None) -> torch.Tensor:
    """Ghost pad of the barotropic streamfunction (N, N) under the
    circulation BC: the perimeter path carries the tridiagonal system
    above with rhs = the boundary cells' psi; the ghosts are 2 sol -
    interior, the corners ghost_x + ghost_y - cell (pg.h:78-163). `minv`
    is `perimeter_inverse` for psi's size, type and device (made here
    when not given)."""
    N = psi.shape[-1]
    if minv is None:
        minv = perimeter_inverse(N, r, ys, L0, dtype=psi.dtype,
                                 device=psi.device)
    rhs = torch.cat([
        psi[0, :],            # bottom, x ascending
        psi[:, -1],           # right, y ascending
        psi[-1, :].flip(0),   # top, x descending
        psi[:, 0].flip(0),    # left, y descending
    ])
    sol = minv @ rhs
    g_bot = 2 * sol[0:N] - psi[0, :]
    g_right = 2 * sol[N:2 * N] - psi[:, -1]
    g_top = 2 * sol[2 * N:3 * N].flip(0) - psi[-1, :]
    g_left = 2 * sol[3 * N:4 * N].flip(0) - psi[:, 0]
    # corners: ghost_x + ghost_y - cell (pg.h:143-157); the padded array is
    # assembled by concatenation, as the JAX package does (its scatter form
    # was miscompiled under SPMD, mspg.py:124-130)
    c00 = g_left[0] + g_bot[0] - psi[0, 0]
    c01 = g_right[0] + g_bot[-1] - psi[0, -1]
    c10 = g_left[-1] + g_top[0] - psi[-1, 0]
    c11 = g_right[-1] + g_top[-1] - psi[-1, -1]
    row_b = torch.cat([c00[None], g_bot, c01[None]])
    row_t = torch.cat([c10[None], g_top, c11[None]])
    mid = torch.cat([g_left[:, None], psi, g_right[:, None]], dim=1)
    return torch.cat([row_b[None, :], mid, row_t[None, :]], dim=0)


# ---------------------------------------------------------------------------
# constants / init
# ---------------------------------------------------------------------------

def build_constants(cfg: PGConfig, *, device="cuda", b_forc=None,
                    wind_fn=None, k_fn=None, b_surf_fn=None) -> PGConstants:
    """One-time set-up on `device`, the barotropic solve included (event
    init, pg.h:921-927). wind_fn(x, y) gives the wind effect (default
    tau0 2 pi y cos(2 (y - ys) pi), pg.c:38 scaled at pg.h:855); k_fn(x, y,
    s) the diffusivity shape (pg.c:26, default 1); b_surf_fn(x, y) the
    surface restoring profile (default 6 cos(pi (y - ys)), pg.c:159-161);
    b_forc the (nl, N, N) QG eddy buoyancy forcing. `bt_stats` records the
    bt solve's cycles."""
    dtype = _torch_dtype(cfg)
    N, nl = cfg.N, cfg.nl
    delta = cfg.L0 / N
    x = (np.arange(N) + 0.5) * delta
    y = cfg.ys + (np.arange(N) + 0.5) * delta
    X, Y = np.meshgrid(x, y, indexing="xy")
    yf = cfg.ys + np.arange(N + 1) * delta     # y-face y-coordinates

    ds = 1.0 / nl
    sf = -1.0 + np.arange(nl + 1) * ds          # sigma faces (pg.h:836-838)
    sc = -1.0 + (np.arange(nl) + 0.5) * ds

    if k_fn is None:
        k_fn = lambda x_, y_, s_: np.ones_like(x_ * y_)
    if wind_fn is None:
        wind_fn = lambda x_, y_: cfg.tau0 * (2 * np.pi * y_
                                             * np.cos(2 * (y_ - cfg.ys)
                                                      * np.pi))
    if b_surf_fn is None:
        b_surf_fn = lambda x_, y_: 6.0 * np.cos(np.pi * (y_ - cfg.ys))

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)

    # elliptic coefficients (pg.h:846-856): alpha = r/(r^2+y^2) on faces,
    # beta-vector fonh = (0, -(r^2-y^2)/(r^2+y^2)^2) at cells
    r = cfg.r
    ax = np.broadcast_to((r / (r**2 + Y[:, 0]**2))[:, None], (N, N + 1))
    ay = np.broadcast_to(r / (r**2 + yf[:, None]**2), (N + 1, N))
    by = -(r**2 - Y**2) / (r**2 + Y**2)**2
    bx = np.zeros((N, N))

    minv = perimeter_inverse(N, r, cfg.ys, cfg.L0, dtype=dtype,
                             device=device)
    pad_fn = lambda a: circ_bc_pad(a, r, cfg.ys, cfg.L0, minv)
    psibt, st = mg.solve_bt(
        torch.zeros((N, N), dtype=dtype, device=device),
        dev(wind_fn(X, Y)), L0=cfg.L0, alpha_x=dev(ax), alpha_y=dev(ay),
        beta_x=dev(bx), beta_y=dev(by), omega=cfg.omega,
        tolerance=cfg.tol, pad_fn=pad_fn)

    # barotropic velocity (bt_velocity, pg.h:353-364) with f = y:
    # u = (-r dpsi/dx - y dpsi/dy)/(r^2+y^2) on x-faces,
    # v = (-r dpsi/dy + y dpsi/dx)/(r^2+y^2) on y-faces
    P = pad_fn(psibt)
    yx = dev(Y[:, 0])[:, None]                           # x-faces: cell y
    dpsidx = (P[1:-1, 1:] - P[1:-1, :-1]) / delta        # (N, N+1)
    dpsidy_x = 0.25 * (P[2:, 1:] - P[:-2, 1:]
                       + P[2:, :-1] - P[:-2, :-1]) / delta
    ubtx = (-r * dpsidx - yx * dpsidy_x) / (r**2 + yx**2)
    yy = dev(yf)[:, None]                                # y-faces: face y
    dpsidy = (P[1:, 1:-1] - P[:-1, 1:-1]) / delta        # (N+1, N)
    dpsidx_y = 0.25 * (P[1:, 2:] - P[1:, :-2]
                       + P[:-1, 2:] - P[:-1, :-2]) / delta
    ubty = (-r * dpsidy + yy * dpsidx_y) / (r**2 + yy**2)
    # no normal flow through the walls (ubt.n = 0, pg.h:905-908)
    ubtx[:, 0] = 0.0
    ubtx[:, -1] = 0.0
    ubty[0, :] = 0.0
    ubty[-1, :] = 0.0

    # diffusivities: kh*k at the cell levels' faces, kv*k at sigma faces
    xfx = np.arange(N + 1) * delta
    Xf, Yfx = np.meshgrid(xfx, y, indexing="xy")
    kx = np.stack([cfg.kh * k_fn(Xf, Yfx, sc[l]) for l in range(nl)])
    Xfy, Yf = np.meshgrid(x, yf, indexing="xy")
    ky = np.stack([cfg.kh * k_fn(Xfy, Yf, sc[l]) for l in range(nl)])
    kv = np.stack([cfg.kv * k_fn(X, Y, sf[l]) for l in range(nl + 1)])

    bf = None
    if b_forc is not None:
        bf = dev(b_forc)
        if tuple(bf.shape) != (nl, N, N):
            raise ValueError(f"b_forc has shape {tuple(bf.shape)}, the "
                             f"config needs {(nl, N, N)}")
    return PGConstants(
        psibt=psibt, ubtx=ubtx, ubty=ubty, b_surf=dev(b_surf_fn(X, Y)),
        b_forc=bf, kx_face=dev(kx), ky_face=dev(ky), kv_prof=dev(kv),
        yc=dev(Y), yf=yy, sc=tuple(sc), sf=tuple(sf), bt_stats=st)


def init_state(cfg: PGConfig, const: PGConstants, *, b0=None,
               u0=None) -> PGState:
    """Rest, or b0 (nl, N, N) and u0 = (ux0, uy0), on the constants'
    device (pg.c:133-162)."""
    dtype, device = const.yc.dtype, const.yc.device
    N, nl = cfg.N, cfg.nl

    def field(a, shape):
        if a is None:
            return torch.zeros(shape, dtype=dtype, device=device)
        a = torch.as_tensor(np.asarray(a), dtype=dtype).to(device)
        if tuple(a.shape) != shape:
            raise ValueError(f"an initial field has shape {tuple(a.shape)}, "
                             f"the config needs {shape}")
        return a

    b = field(b0, (nl, N, N))
    ux = field(None if u0 is None else u0[0], (nl, N, N + 1))
    uy = field(None if u0 is None else u0[1], (nl, N + 1, N))
    zero = torch.zeros((), dtype=dtype, device=device)
    izero = torch.zeros((), dtype=torch.int32, device=device)
    return PGState(b=b, ux=ux, uy=uy, t=zero, dt_prev=zero.clone(), i=izero,
                   b_me=torch.zeros_like(b), ux_me=torch.zeros_like(ux),
                   uy_me=torch.zeros_like(uy), nme=izero.clone())


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------

def _vert_ghost(b):
    """vertbc (pg.h:374-387): zero-gradient vertical ghost layers."""
    return torch.cat([b[:1], b, b[-1:]])


def _pad_b(b):
    """Horizontal ghost pad of a cell field: symmetry (no-flux walls)."""
    return pad(b, BC.NEUMANN)


def advection(cfg: PGConfig, const: PGConstants, b, ux, uy):
    """Flux-form 3-D advection with the diagnostic w from continuity
    integrated bottom up (pg.h:397-439). Returns db (nl, N, N) and w at
    each layer's top face."""
    return _advection(cfg, _pad_b(b), ux, uy)


def _advection(cfg: PGConfig, bp, ux, uyf):
    """advection from the ghosted buoyancy bp (nl, ny+2, nx+2) and the
    y-faces uyf (nl, ny+1, nx) of its ny rows of cells."""
    nl = cfg.nl
    delta = cfg.L0 / cfg.N
    ds = 1.0 / nl
    bC = bp[:, 1:-1, 1:-1]
    bE, bW = bp[:, 1:-1, 2:], bp[:, 1:-1, :-2]
    bN, bS = bp[:, 2:, 1:-1], bp[:, :-2, 1:-1]
    # horizontal flux convergence (pg.h:420-424)
    dbh = ((bC + bW) * ux[:, :, :-1] - (bC + bE) * ux[:, :, 1:]
           + (bC + bS) * uyf[:, :-1, :] - (bC + bN) * uyf[:, 1:, :]) \
        / (2 * delta)
    # w[k] at the top face of layer k, from w = 0 at the sea floor: the
    # divergence of the layers below reduces it upward (pg.h:418)
    div = (ux[:, :, 1:] - ux[:, :, :-1] + uyf[:, 1:, :] - uyf[:, :-1, :]) \
        * ds / delta
    w_top = -torch.cumsum(div.flip(0), dim=0).flip(0)
    w_bot = torch.cat([w_top[1:], torch.zeros_like(w_top[:1])])
    bg = _vert_ghost(bC)
    b_below, b_above = bg[2:], bg[:-2]
    dbv = ((bC + b_below) * w_bot - (bC + b_above) * w_top) / (2 * ds)
    return dbh + dbv, w_top


def hdiffusion(cfg: PGConfig, const: PGConstants, b):
    """Explicit horizontal diffusion, face-flux form (pg.h:514-542)."""
    return _hdiffusion(cfg, const, _pad_b(b))


def _hdiffusion(cfg: PGConfig, const: PGConstants, bp):
    """hdiffusion from the ghosted buoyancy; const.ky_face holds the
    y-faces of bp's rows of cells."""
    delta = cfg.L0 / cfg.N
    fx = const.kx_face * (bp[:, 1:-1, 1:] - bp[:, 1:-1, :-1]) / delta
    fy = const.ky_face * (bp[:, 1:, 1:-1] - bp[:, :-1, 1:-1]) / delta
    return (fx[:, :, 1:] - fx[:, :, :-1] + fy[:, 1:, :] - fy[:, :-1, :]) \
        / delta


def vdiff_implicit(cfg: PGConfig, const: PGConstants, b, dt):
    """Implicit vertical diffusion with the surface-flux injection
    (pg.h:450-508): kv_prof[l] = kv*k at sigma face sf[l]; the surface
    flux takes 2 K0 (half a cell), the bottom flux vanishes."""
    nl = cfg.nl
    ds = 1.0 / nl
    K = const.kv_prof
    b = torch.cat([(b[0] + dt * 2.0 * K[0] / (ds * ds) * const.b_surf)[None],
                   b[1:]])
    # surface: ad = 0, cd = -dt K[1]/ds^2, bd = 1 - cd + 2 dt K[0]/ds^2;
    # interior: ad = -dt K[l]/ds^2, cd = -dt K[l+1]/ds^2, bd = 1 - ad - cd;
    # bottom: cd = 0 (pg.h:470-490)
    c = dt / (ds * ds)
    ad = torch.cat([torch.zeros_like(K[:1]), -c * K[1:nl]])
    cd = torch.cat([-c * K[1:nl], torch.zeros_like(K[:1])])
    bd = 1.0 - ad - cd
    bd = torch.cat([(bd[0] + 2.0 * c * K[0])[None], bd[1:]])
    return tridiag.thomas(ad, bd, cd, b)


def convection(b):
    """Convective adjustment: one top-down sweep averaging each unstable
    pair (the deeper layer lighter, pg.h:548-579). Sequential on purpose:
    pair l+1 sees layer l+1 as pair l left it."""
    layers = list(b.unbind(0))
    for l in range(len(layers) - 1):
        unstable = layers[l + 1] > layers[l]
        avg = 0.5 * (layers[l] + layers[l + 1])
        layers[l] = torch.where(unstable, avg, layers[l])
        layers[l + 1] = torch.where(unstable, avg, layers[l + 1])
    return torch.stack(layers)


def forcing_implicit(cfg: PGConfig, const: PGConstants, b, dt):
    """Implicit surface relaxation b1 = (b_surf dt + b1 tau_s)/(dt + tau_s)
    (pg.h:586-592)."""
    top = (const.b_surf * dt + b[0] * cfg.tau_s) / (dt + cfg.tau_s)
    return torch.cat([top[None], b[1:]])


def momentum(cfg: PGConfig, const: PGConstants, b, ux, uy):
    """Hydrostatic pressure and the momentum tendency du = -grad p - f
    u^perp - r u + nu lap u on the faces, f = y (pg.h:612-646)."""
    return _momentum(cfg, const, b, ux, uy, _pad_face_x(ux),
                     _pad_face_y(uy), _pad_b)


def _momentum(cfg: PGConfig, const: PGConstants, b, ux, uy, Px, Py, pad_c):
    """momentum from the ghosted faces Px (nl, ny+2, nx+3) and Py (uy's
    rows with a ghost row each side, x-ghosted) and `pad_c`, the ghost
    rule of a cell field; uy (and const.ubty, const.yf) hold the y-faces
    the result is wanted on, the first ny or all ny+1 of the cells'."""
    delta = cfg.L0 / cfg.N
    ds = 1.0 / cfg.nl
    ny, nf = b.shape[-2], uy.shape[-2]
    # hydrostatic: p[0] = -b[0] ds/2; p[l] = p[l-1] - (b[l-1]+b[l]) ds/2
    incr = torch.cat([-b[:1] * 0.5 * ds, -0.5 * (b[:-1] + b[1:]) * ds])
    p = torch.cumsum(incr, dim=0)
    pp = pad_c(p)
    dpdx = (pp[:, 1:-1, 1:] - pp[:, 1:-1, :-1]) / delta      # (nl, N, N+1)
    dpdy = (pp[:, 1:nf + 1, 1:-1] - pp[:, :nf, 1:-1]) / delta
    # v at the x-faces: the 4 y-faces of the two cells beside the x-face
    # (pg.h:641), with mirrored x-ghost columns of uy; u likewise
    uyg = Py[:, 1:ny + 2, :]
    vbar = 0.25 * (uyg[:, :-1, :-1] + uyg[:, :-1, 1:]
                   + uyg[:, 1:, :-1] + uyg[:, 1:, 1:])       # (nl, N, N+1)
    uxg = Px[:, :nf + 1, 1:-1]
    ubar = 0.25 * (uxg[:, :-1, :-1] + uxg[:, :-1, 1:]
                   + uxg[:, 1:, :-1] + uxg[:, 1:, 1:])       # (nl, N+1, N)
    yx = const.yc[:, :1]                                     # (N, 1) cell y
    lap_ux = _lap_face(Px, ux, delta)
    lap_uy = _lap_face(Py, uy, delta)
    dux = -dpdx + yx * vbar - cfg.r * ux + cfg.nu * lap_ux
    duy = -dpdy - const.yf * ubar - cfg.r * uy + cfg.nu * lap_uy
    return dux, duy


def _pad_face_x(ux):
    """Ghost pad of an x-face field: the normal ghost faces mirror (the
    wall face itself carries u.n = 0), the tangential ghost rows too."""
    g = torch.cat([ux[:, :, :1], ux, ux[:, :, -1:]], dim=-1)
    return torch.cat([g[:, :1], g, g[:, -1:]], dim=-2)


def _pad_face_y(uy):
    g = torch.cat([uy[:, :1, :], uy, uy[:, -1:, :]], dim=-2)
    return torch.cat([g[:, :, :1], g, g[:, :, -1:]], dim=-1)


def _lap_face(P, u, delta):
    return (P[:, 1:-1, 2:] + P[:, 1:-1, :-2] + P[:, 2:, 1:-1]
            + P[:, :-2, 1:-1] - 4 * u) / (delta * delta)


def adjust_bt_velocity(cfg: PGConfig, const: PGConstants, ux, uy, btfac):
    """Remove the vertical mean and add btfac ubt (pg.h:649-672)."""
    ds = 1.0 / cfg.nl
    ux_me = torch.sum(ux * ds, dim=0, keepdim=True)
    uy_me = torch.sum(uy * ds, dim=0, keepdim=True)
    return (ux + btfac * const.ubtx[None] - ux_me,
            uy + btfac * const.ubty[None] - uy_me)


def comp_gm(cfg: PGConfig, const: PGConstants, b):
    """Gent-McWilliams eddy-induced face velocities (pg.h:682-724): at each
    face the Ferrari et al. (2010) Eq. 16 tridiagonal for upsilon at the
    nl-1 interior interfaces, c1 = max(cmin, sqrt|b_surf - b_bot|/pi),
    then u_gm = d upsilon/dz."""
    return _comp_gm(cfg, _pad_b(b))


def _comp_gm(cfg: PGConfig, bp, first=True, last=True):
    """comp_gm from the ghosted buoyancy: the x-faces of bp's rows of
    cells and all their y-faces; `first`/`last` say whether the bottom
    and top y-faces are the domain's walls."""
    nl = cfg.nl
    if nl < 2:
        b = bp[:, 1:-1, 1:-1]
        return torch.zeros_like(b[:, :, :1]), torch.zeros_like(b[:, :1, :])
    delta = cfg.L0 / cfg.N
    ds = 1.0 / nl

    def gm_for(bL, bR):
        c_bc1 = torch.sqrt(torch.abs(bR[0] - bR[nl - 1])) / np.pi
        c2 = torch.clamp(c_bc1, min=cfg.cmin) ** 2
        # interfaces l = 0..nl-2 between layers l and l+1
        dbdx = 0.5 * (bR[:-1] - bL[:-1] + bR[1:] - bL[1:]) / delta
        rhs = -cfg.k_gm * dbdx
        N2 = torch.clamp(0.5 * ((bR[:-1] - bR[1:]) + (bL[:-1] - bL[1:]))
                         / ds, min=cfg.N2min)
        ad = (c2 / (ds * ds)).expand_as(rhs)
        bd = -2.0 * c2 / (ds * ds) - N2
        zero = torch.zeros_like(ad[:1])
        ups = tridiag.thomas(torch.cat([zero, ad[1:]]), bd,
                             torch.cat([ad[:-1], zero]), rhs)
        # u_gm[l] = (ups[l-1] - ups[l])/ds with ups[-1] = ups[nl-1] = 0
        zu = torch.zeros_like(ups[:1])
        return (torch.cat([zu, ups]) - torch.cat([ups, zu])) / ds

    ugm_x = gm_for(bp[:, 1:-1, :-1], bp[:, 1:-1, 1:])
    ugm_y = gm_for(bp[:, :-1, 1:-1], bp[:, 1:, 1:-1])
    return _zero_walls(ugm_x, ugm_y, first, last)


def _zero_walls(ux, uy, first=True, last=True):
    """No normal flow at the walls: ux's first and last columns, and uy's
    first row where it is the bottom wall (`first`) and its last where it
    is the top wall (`last`)."""
    ux = torch.cat([torch.zeros_like(ux[..., :1]), ux[..., 1:-1],
                    torch.zeros_like(ux[..., :1])], dim=-1)
    zero = torch.zeros_like(uy[..., :1, :])
    lo = 1 if first else 0
    hi = uy.shape[-2] - 1 if last else uy.shape[-2]
    uy = torch.cat([zero] * first + [uy[..., lo:hi, :]] + [zero] * last,
                   dim=-2)
    return ux, uy


def cfl_dtmax(cfg: PGConfig, ux, uy, dtmax0, prev, pmax=None):
    """timestep(u) layer by layer, bottom up, sharing the `previous`
    smoothing state (pg.h:432-436). 0-d tensors: no host sync. `pmax`
    takes the per-layer maxima over the ranks of a sharded step."""
    delta = cfg.L0 / cfg.N
    dtype = ux.dtype
    big = torch.finfo(dtype).max / 4
    # the per-layer maxima in one pass; the recurrence stays sequential
    umax = torch.maximum(ux.abs().amax(dim=(1, 2)), uy.abs().amax(dim=(1, 2)))
    if pmax is not None:
        umax = pmax(umax)
    dtm = torch.as_tensor(dtmax0, dtype=dtype, device=ux.device)
    for l in range(cfg.nl - 1, -1, -1):
        dt_cfl = torch.where(umax[l] > 0, cfg.CFL * delta / umax[l], big)
        dtm = torch.minimum(dtm, dt_cfl)
        dtm = torch.where(dtm > prev, (prev + 0.1 * dtm) / 1.1, dtm)
        prev = dtm
    return dtm, prev


# ---------------------------------------------------------------------------
# update / advance / step (predictor-corrector, pg.h:733-800)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Halo:
    """The ghost rules of the step's stencils: `cells` gives a cell field
    its ghost ring, `x_faces` and `y_faces` an x- or y-face field its
    ghost ring (ghost rows, the y-faces' against the field's own first and
    last rows), `pmax` the maximum over the ranks (None: one process);
    `first` and `last` say whether the field's first and last rows lie at
    the south and north walls. WHOLE is the whole domain's: mirrored ghosts
    at every wall. A rank of the rows split (parallel/pg_step.py) takes
    its ghost rows from its neighbours."""
    cells: Callable = _pad_b
    x_faces: Callable = _pad_face_x
    y_faces: Callable = _pad_face_y
    pmax: Callable | None = None
    first: bool = True
    last: bool = True


WHOLE = Halo()


def update_pg(cfg: PGConfig, const: PGConstants, b, ux, uy, prev, dtmax0,
              halo: Halo = WHOLE):
    """One tendency evaluation: (db, dux, duy, dtm, prev). The ghost rings
    of b, ux and uy are made once and shared by the stencils."""
    bp = halo.cells(b)
    Px, Py = halo.x_faces(ux), halo.y_faces(uy)
    # the y-faces of b's rows of cells, both walls included
    uyf = Py[:, 1:b.shape[-2] + 2, 1:-1]
    db, _ = _advection(cfg, bp, ux, uyf)
    dtm, prev = cfl_dtmax(cfg, ux, uy, dtmax0, prev, halo.pmax)
    if cfg.k_gm > 0:
        gx, gy = _comp_gm(cfg, bp, halo.first, halo.last)
        db_gm, _ = _advection(cfg, bp, gx, gy)
        db = db + db_gm
        dtm, prev = cfl_dtmax(cfg, gx, gy, dtm, prev, halo.pmax)
    db = db + _hdiffusion(cfg, const, bp)
    if const.b_forc is not None:
        db = db + const.b_forc
    dux, duy = _momentum(cfg, const, b, ux, uy, Px, Py, halo.cells)
    return db, dux, duy, dtm, prev


def advance_pg(cfg: PGConfig, const: PGConstants, b, ux, uy, db, dux, duy,
               dt, halo: Halo = WHOLE):
    """An Euler substep, then the implicit surface relaxation, vertical
    diffusion, convection and the barotropic adjustment."""
    b = b + db * dt
    ux = ux + dux * dt
    uy = uy + duy * dt
    b = forcing_implicit(cfg, const, b, dt)
    b = vdiff_implicit(cfg, const, b, dt)
    b = convection(b)
    ux, uy = adjust_bt_velocity(cfg, const, ux, uy, 1.0)
    ux, uy = _zero_walls(ux, uy, halo.first, halo.last)
    return b, ux, uy


def make_step(cfg: PGConfig, halo: Halo = WHOLE):
    """step(state, const, tnext) -> (state, PGStepDiag): dt from the first
    update's CFL chain clamped by `qg.dtnext`, a half-step predictor, the
    corrector's tendency at the midpoint and the full step. The running
    means pass through unchanged (`accumulate_means` updates them).
    `halo` is the ghost rules' (a rank's rows: parallel/pg_step.py)."""
    DT = cfg.DT

    def step(state: PGState, const: PGConstants, tnext):
        db, dux, duy, dtm, prev = update_pg(cfg, const, state.b, state.ux,
                                            state.uy, state.dt_prev, DT,
                                            halo)
        dt = dtnext(state.t, tnext, dtm)
        bh, uxh, uyh = advance_pg(cfg, const, state.b, state.ux, state.uy,
                                  db, dux, duy, dt / 2, halo)
        db2, dux2, duy2, _, prev = update_pg(cfg, const, bh, uxh, uyh, prev,
                                             DT, halo)
        b, ux, uy = advance_pg(cfg, const, state.b, state.ux, state.uy,
                               db2, dux2, duy2, dt, halo)
        new = PGState(b=b, ux=ux, uy=uy, t=state.t + dt, dt_prev=prev,
                      i=state.i + 1, b_me=state.b_me, ux_me=state.ux_me,
                      uy_me=state.uy_me, nme=state.nme)
        return new, PGStepDiag(dt=dt)

    return step


def accumulate_means(state: PGState) -> PGState:
    """comp_output's running means, every 10 steps (pg.c:179-203). The
    reference averages u_gm into u_mel; here, as in the JAX package, the
    resolved u is averaged (a documented deviation)."""
    nme = state.nme
    b_me = (state.b_me * nme + state.b) / (nme + 1)
    ux_me = (state.ux_me * nme + state.ux) / (nme + 1)
    uy_me = (state.uy_me * nme + state.uy) / (nme + 1)
    return dataclasses.replace(state, b_me=b_me, ux_me=ux_me, uy_me=uy_me,
                               nme=nme + 1)
