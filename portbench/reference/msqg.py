"""Plain reference of the msqg step: the multi-layer quasi-geostrophic model
of `bderembl/msom` (msqg/qg.h, msqg/qg.c) on a walled square basin, written
from the model's equations in plain PyTorch.

It imports nothing of the program under test. From the configuration's keys
it works out again everything the program derives (layer metrics, the
stretching matrix and its vertical modes, the wind profile, the sine basis
of the Laplacian) and solves the PV inversion exactly, by the dense
orthonormal DST-II basis in both directions, whatever solver the program
uses. What it covers: free-slip walls (sbc = 0), uniform stretching
(varRo = 0), no large-scale flow, topography, tracers or stochastic forcing,
the harmonic and biharmonic dissipation, bottom and surface Ekman friction
and the wind. `Model` raises ValueError for any other configuration.

Discretisation, as the model's:
  - fields are cell-centred on an N x N grid of spacing delta = L0 / N,
    with one ghost cell a side: psi, zeta and the Laplacian of zeta take
    ghost = -interior (a zero value on the wall), x first and then y, so a
    corner ghost is +interior corner;
  - lap is the 5-point Laplacian, the advection the 12-point Arakawa
    bracket, beta the centred x-difference;
  - q = lap(psi) + Gamma(psi), Gamma the vertical stretching with
    s_l = (Fr_l / Rom)^2 at the nl - 1 interfaces;
  - the step is the predictor-corrector: dt from the CFL controller on the
    first update (the per-layer face-speed maxima, each smoothed by
    dt <- (prev + 0.1 dt) / 1.1 where it grows), clamped so that whole steps
    land on the next event; q1 = q0 + dt/2 * rhs(inv(q0)); q = q0 + dt *
    rhs(inv(q1)); the state keeps psi = inv(q1).

`dtype` is the type of every field and of the 0-d clock (t, dt and the
controller's smoothing state), as in the model, whose time has the type
of its fields.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class State:
    q: torch.Tensor          # (nl, N, N) potential vorticity
    psi: torch.Tensor        # (nl, N, N) streamfunction, inv(q1) of the step
    t: torch.Tensor          # 0-d model time
    dt_prev: torch.Tensor    # 0-d state of the CFL controller's smoothing
    i: int                   # steps taken


def _pad(a: torch.Tensor) -> torch.Tensor:
    """One ghost cell a side, ghost = -interior: x first, then y."""
    a = torch.cat([-a[..., :1], a, -a[..., -1:]], dim=-1)
    return torch.cat([-a[..., :1, :], a, -a[..., -1:, :]], dim=-2)


def _lap(p: torch.Tensor, d: float) -> torch.Tensor:
    """5-point Laplacian of a padded field."""
    return (p[..., 1:-1, 2:] + p[..., 1:-1, :-2] + p[..., 2:, 1:-1]
            + p[..., :-2, 1:-1] - 4.0 * p[..., 1:-1, 1:-1]) / (d * d)


def _mjac(p: torch.Tensor, q: torch.Tensor, d: float) -> torch.Tensor:
    """-J(p, q), the 12-point Arakawa bracket of two padded fields
    (the msqg macro at msqg/qg.h:252-262)."""
    def at(f, dj, di):
        ny, nx = f.shape[-2] - 2, f.shape[-1] - 2
        return f[..., 1 + dj:1 + dj + ny, 1 + di:1 + di + nx]
    pE, pW, pN, pS = at(p, 0, 1), at(p, 0, -1), at(p, 1, 0), at(p, -1, 0)
    pNE, pNW, pSE, pSW = at(p, 1, 1), at(p, 1, -1), at(p, -1, 1), \
        at(p, -1, -1)
    qE, qW, qN, qS = at(q, 0, 1), at(q, 0, -1), at(q, 1, 0), at(q, -1, 0)
    qNE, qNW, qSE, qSW = at(q, 1, 1), at(q, 1, -1), at(q, -1, 1), \
        at(q, -1, -1)
    j = ((qE - qW) * (pN - pS) + (qS - qN) * (pE - pW)
         + qE * (pNE - pSE) - qW * (pNW - pSW)
         - qN * (pNE - pNW) + qS * (pSE - pSW)
         + pN * (qNE - qNW) - pS * (qSE - qSW)
         - pE * (qNE - qSE) + pW * (qNW - qSW))
    return j / (12.0 * d * d)


def layer_metrics(dh) -> tuple[np.ndarray, np.ndarray]:
    """(idh0, idh1): 1 / (dhc dh) above and below each layer, 0 at the top
    and the bottom (msqg/qg.h:1017-1027)."""
    dh = np.asarray(dh, np.float64)
    nl = len(dh)
    dhc = 0.5 * (dh[:-1] + dh[1:])
    idh0, idh1 = np.zeros(nl), np.zeros(nl)
    for l in range(nl - 1):
        idh1[l] = 1.0 / (dhc[l] * dh[l])
        idh0[l + 1] = 1.0 / (dhc[l] * dh[l + 1])
    return idh0, idh1


def dst2_basis(N: int) -> np.ndarray:
    """The orthonormal DST-II matrix: row k is c_k sin(pi (k+1)(i+1/2) / N),
    the eigenvectors of the 1-D second difference with ghost = -interior."""
    k = np.arange(N)[:, None]
    i = np.arange(N)[None, :]
    c = np.full((N, 1), math.sqrt(2.0 / N))
    c[-1] = math.sqrt(1.0 / N)
    return c * np.sin(np.pi * (k + 1) * (i + 0.5) / N)


class Model:
    """The msqg model of one configuration (a dict of the model's keys, as
    in the deck) in `dtype` on `device`."""

    def __init__(self, keys: dict, *, dtype=torch.float64, device="cpu"):
        k = dict(keys)
        for name, allowed in (("sbc", (0, 0.0)), ("varRo", (0,)),
                              ("nptr", (0,)), ("flsrv", (0,)),
                              ("energy_conserv", (False,)),
                              ("stochastic", (False,)),
                              ("upg", ((), [])), ("vpg", ((), []))):
            if k.get(name, allowed[0]) not in allowed:
                raise ValueError(f"the reference has no {name} = "
                                 f"{k[name]!r}")
        self.N, self.nl, self.L0 = int(k["N"]), int(k["nl"]), float(k["L0"])
        N, nl = self.N, self.nl
        self.d = self.L0 / N
        self.dtype, self.device = dtype, device
        self.Rom = float(k["Rom"])
        self.beta = float(k.get("beta", 0.5))
        self.dh = [float(v) for v in k["dh"][:nl]]
        Re, Re4 = float(k.get("Re", 0.0)), float(k.get("Re4", 0.0))
        self.iRe = 0.0 if Re == 0 else 1.0 / Re
        self.iRe4 = 0.0 if Re4 == 0 else -1.0 / Re4
        self.eks = float(k.get("Eks", 0.0)) / (self.Rom * 2 * self.dh[0])
        self.ekb = float(k.get("Ekb", 0.0)) / (self.Rom * 2 * self.dh[-1])
        self.CFL = float(k.get("CFL", 0.5))
        self.tend = float(k.get("tend", 1.0))
        # the viscous clamps on DT, applied when the deck is read
        DT = float(k.get("DT", 1e10))
        if Re != 0:
            DT = 0.5 * min(DT, self.d ** 2 * Re / 4.0)
        if Re4 != 0:
            DT = 0.5 * min(DT, self.d ** 4 * Re4 / 32.0)
        self.DT = DT

        idh0, idh1 = layer_metrics(self.dh)
        self.idh0, self.idh1 = idh0, idh1
        s = np.array([(float(f) / self.Rom) ** 2 for f in k["Fr"][:nl - 1]])
        self.s = s
        # Gamma as an nl x nl matrix on the layers, and its vertical modes
        G = np.zeros((nl, nl))
        for l in range(nl):
            if l > 0:
                G[l, l - 1] += s[l - 1] * idh0[l]
                G[l, l] -= s[l - 1] * idh0[l]
            if l < nl - 1:
                G[l, l + 1] += s[l] * idh1[l]
                G[l, l] -= s[l] * idh1[l]
        lam, V = np.linalg.eig(G)
        if np.abs(lam.imag).max() > 0 or np.abs(V.imag).max() > 0:
            raise ValueError("the stretching matrix has complex modes")
        lam, V = lam.real, V.real

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float64)).to(
                device=device, dtype=dtype)

        self.m2l, self.l2m = dev(V), dev(np.linalg.inv(V))
        self.S = dev(dst2_basis(N))
        kk = np.arange(1, N + 1)
        ev = -(4.0 / self.d ** 2) * np.sin(np.pi * kk / (2 * N)) ** 2
        den = lam[:, None, None] + ev[None, :, None] + ev[None, None, :]
        self.inv_den = dev(1.0 / den)
        y = (np.arange(N) + 0.5) * self.d
        self.wind = dev(float(k["tau0"]) / (self.Rom * self.dh[0])
                        * np.sin(2 * np.pi * y / self.L0)
                        * np.sin(np.pi * y / self.L0))[:, None]

    # -- operators ---------------------------------------------------------

    def stretch(self, a: torch.Tensor) -> torch.Tensor:
        """Gamma(a), layer by layer."""
        out = torch.zeros_like(a)
        for l in range(self.nl - 1):
            up = self.s[l] * (a[l] - a[l + 1])
            out[l] -= up * self.idh1[l]
            out[l + 1] += up * self.idh0[l + 1]
        return out

    def comp_q(self, psi: torch.Tensor) -> torch.Tensor:
        return _lap(_pad(psi), self.d) + self.stretch(psi)

    def invert(self, q: torch.Tensor) -> torch.Tensor:
        """The exact solution psi of lap(psi) + Gamma(psi) = q: the modes,
        the 2-D DST-II, the division, back."""
        S = self.S
        qm = torch.einsum("ml,lyx->myx", self.l2m, q)
        pm = S.T @ ((S @ qm @ S.T) * self.inv_den) @ S
        return torch.einsum("lm,myx->lyx", self.m2l, pm)

    def rhs(self, psi: torch.Tensor):
        """(dq, umax): the tendency of q (update_qg, msqg/qg.h:609-650) and
        the per-layer maximum face speed of psi."""
        d, nl = self.d, self.nl
        pp = _pad(psi)
        zeta = _lap(pp, d)
        zp = _pad(zeta)
        dq = torch.zeros_like(psi)
        if nl > 1:
            dq = dq + _mjac(pp, zp, d)
            dq = dq + self.beta * (pp[..., 1:-1, :-2] - pp[..., 1:-1, 2:]) \
                / (2.0 * d)
            J = _mjac(pp[:-1], pp[1:], d)
            for l in range(nl - 1):
                dq[l] += self.s[l] * J[l] * self.idh1[l]
                dq[l + 1] -= self.s[l] * J[l] * self.idh0[l + 1]
        if self.iRe != 0.0 or self.iRe4 != 0.0:
            tmp = _lap(zp, d)
        if self.iRe != 0.0:
            dq = dq + self.iRe * (self.stretch(zeta) + tmp)
        if self.iRe4 != 0.0:
            dq = dq + self.iRe4 * (_lap(_pad(tmp), d) + self.stretch(tmp))
        dq[0] -= self.eks * zeta[0]
        dq[nl - 1] -= self.ekb * zeta[nl - 1]
        dq[0] -= self.wind
        return dq, self.face_speed(pp)

    def face_speed(self, pp: torch.Tensor) -> torch.Tensor:
        """Per layer, the largest |u| over the x-faces and |v| over the
        y-faces, each face's the mean of its two cells' centred
        derivatives, the wall faces through the ghosts."""
        d = self.d
        uc = -(pp[..., 2:, :] - pp[..., :-2, :]) / (2.0 * d)
        vc = (pp[..., :, 2:] - pp[..., :, :-2]) / (2.0 * d)
        fx = (0.5 * (uc[..., 1:] + uc[..., :-1])).abs().amax(dim=(-2, -1))
        fy = (0.5 * (vc[..., 1:, :] + vc[..., :-1, :])).abs() \
            .amax(dim=(-2, -1))
        return torch.maximum(fx, fy)

    def cfl(self, umax: torch.Tensor, prev: torch.Tensor):
        """(dt, prev) of the CFL controller: layer by layer, the CFL limit,
        then the smoothing where dt grows."""
        dt = torch.full((), self.DT, dtype=self.dtype, device=umax.device)
        for l in range(self.nl):
            if umax[l] > 0:
                dt = torch.minimum(dt, self.CFL * self.d / umax[l])
            if dt > prev:
                dt = (prev + 0.1 * dt) / 1.1
            prev = dt
        return dt, prev

    @staticmethod
    def dtnext(t, tnext: float, dt):
        """dt shrunk so that whole steps land on the event time tnext
        (Basilisk's dtnext, TEPS = 1e-9)."""
        dd = tnext - t
        n = torch.floor(dd / dt)
        if n == 0:
            return dd
        dt1 = dd / torch.clamp(n, min=1)
        if dt1 > dt * (1.0 + 1e-9):
            dt1 = dd / (n + 1)
        return torch.minimum(dt, dt1)

    # -- states ------------------------------------------------------------

    def initial(self, psi0: torch.Tensor) -> State:
        """The initial state from psi0: each layer's mean taken out, q from
        psi, t = 0, the controller at 0 (msqg/qg.c:53-92)."""
        psi = psi0.to(device=self.device, dtype=self.dtype)
        psi = psi - psi.mean(dim=(-2, -1), keepdim=True)
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        return State(q=self.comp_q(psi), psi=psi, t=zero, dt_prev=zero, i=0)

    def from_program(self, q, t, dt_prev, i) -> State:
        """A state taken over from the program: its q, clock and step
        count; psi is not read by the step."""
        q = q.to(device=self.device, dtype=self.dtype)
        as_clock = dict(device=self.device, dtype=self.dtype)
        return State(q=q, psi=torch.zeros_like(q),
                     t=torch.as_tensor(t).to(**as_clock),
                     dt_prev=torch.as_tensor(dt_prev).to(**as_clock),
                     i=int(i))

    def step(self, st: State) -> State:
        """One predictor-corrector step towards tnext = tend (the run's
        output and filter events lie beyond it)."""
        q0 = st.q
        psi1 = self.invert(q0)
        dq, umax = self.rhs(psi1)
        dtm, prev = self.cfl(umax, st.dt_prev)
        dt = self.dtnext(st.t, self.tend, dtm)
        q1 = q0 + dq * (0.5 * dt)
        psi2 = self.invert(q1)
        dq, umax = self.rhs(psi2)
        _, prev = self.cfl(umax, prev)
        return State(q=q0 + dq * dt, psi=psi2, t=st.t + dt,
                     dt_prev=prev, i=st.i + 1)

    def advance(self, st: State, steps: int) -> State:
        for _ in range(steps):
            st = self.step(st)
        return st
