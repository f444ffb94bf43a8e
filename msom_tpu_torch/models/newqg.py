"""newqg, the transitional cell-centred single/multi-layer QG model (the
port of `msom_tpu.models.newqg`; reference newqg/qg.h + qg.c).

Cell-centred (nl, N, N) fields on msqg's grid and stencils. The inversion
is the plain Helmholtz problem lap(psi) + iRd2_low psi = q, whose
coefficient -f0^2/(gp_low dh[nl-1]) lives in the bottom layer only
(qg.h:345-354): the layers are otherwise uncoupled. The tendency is
Arakawa advection with the opposite-sign beta convention (rhs = -J(psi,
zeta) - beta v), harmonic dissipation, bottom Ekman friction and the pulse
wind localised in time and x (qg.c:69-75); the step is the predictor-
corrector with the inline CFL and its previous-dt smoothing (qg.h:202-219).
The zeta ghosts follow msqg's partial-slip law (pad_zeta_slip; the
bc_fac = sbc/((0.5 sbc + 1) Delta^2) rule of qg.h:295-318), or wrap with
sbc = -1.

The inversion is the layered multigrid (solver="mg": its levels carry the
Helmholtz coefficient as a y-profile, so on the card the walled sweeps and
residuals run kernels K3 and K4) or the exact spectral solve with the
per-layer coefficients (solver="spectral", `spectral.build_spectral(lam=)`,
walled or periodic). Everything else is torch ops, as the JAX package runs
XLA ops. The state lives on the device of `make_step`'s and `init_state`'s
`device` (default "cuda").
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from msom_tpu_torch.models.qg import dtnext
from msom_tpu_torch.ops.bc import BC, pad, pad_zeta_slip
from msom_tpu_torch.ops.stencil import (arakawa_mjac, face_velocities,
                                        laplacian, shift)
from msom_tpu_torch.params import _parse_kv
from msom_tpu_torch.solvers import mg, spectral


@dataclasses.dataclass(frozen=True)
class NewQGConfig:
    """Defaults per reference newqg/qg.h:85-95."""
    N: int = 64
    nl: int = 1
    L0: float = 1.0
    f0: float = 1.0
    beta: float = 0.0
    hEkb: float = 0.0
    tau0: float = 0.0
    nu: float = 0.0
    sbc: float = 0.0
    gp_low: float = 0.0
    dh: Tuple[float, ...] = (1.0,)
    DT: float = 1e10
    tend: float = 1.0
    dtout: float = 1.0
    CFL: float = 0.5
    TOLERANCE: float = 1e-5
    dtype: str = "float64"
    solver: str = "mg"       # "mg" or "spectral" (exact direct, constant lam)

    def __post_init__(self):
        if self.solver not in ("mg", "spectral"):
            raise ValueError(f"solver={self.solver!r}: must be 'mg' or "
                             "'spectral'")

    @property
    def delta(self):
        return self.L0 / self.N

    @property
    def iRd2_low(self):
        """The NEGATIVE Helmholtz coefficient (qg.h:348-350)."""
        if self.gp_low != 0.0:
            return -self.f0 ** 2 / (self.gp_low * self.dh[self.nl - 1])
        return 0.0


_KEYS = frozenset(f.name for f in dataclasses.fields(NewQGConfig))


def load_newqg_config(path_or_text, **overrides) -> NewQGConfig:
    """A newqg params.in (a path or its text); keys the model does not
    know are ignored, `overrides` win."""
    kv = _parse_kv(path_or_text)
    kw = {k: v for k, v in kv.items() if k in _KEYS}
    if "dh" in kw and not isinstance(kw["dh"], tuple):
        kw["dh"] = (float(kw["dh"]),)
    kw.update(overrides)
    return NewQGConfig(**kw)


@dataclasses.dataclass
class NewQGState:
    q: torch.Tensor               # (nl, N, N) potential vorticity
    psi: torch.Tensor             # (nl, N, N) streamfunction
    t: torch.Tensor               # 0-d model time
    dt_prev: torch.Tensor         # 0-d CFL smoothing state
    i: torch.Tensor               # 0-d int32 step counter


class NewQGDiag(NamedTuple):
    dt: torch.Tensor
    ke: torch.Tensor              # top-layer kinetic energy
    mg_iters: int                 # V-cycles of the step's first inversion


def _torch_dtype(cfg: NewQGConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _bc(cfg: NewQGConfig) -> BC:
    return BC.PERIODIC if cfg.sbc == -1 else BC.DIRICHLET


def lam_per_layer(cfg: NewQGConfig) -> np.ndarray:
    """(nl,) Helmholtz coefficients: -1/Rd^2 in the bottom layer only
    (reference newqg/qg.h:148-157, 174-178); the multigrid's coefficient
    field and the spectral denominators both come from it."""
    lam_vec = np.zeros(cfg.nl)
    lam_vec[cfg.nl - 1] = cfg.iRd2_low
    return lam_vec


def build_levels(cfg: NewQGConfig, device="cuda"):
    """(levels, lam): the multigrid levels and the (nl, N, N) Helmholtz
    field, None without gp_low (qg.h:174-178), on `device`. The field is
    constant along x, so every level keeps it as a y-profile."""
    dtype = _torch_dtype(cfg)
    lam = None
    if cfg.iRd2_low != 0.0:
        lam = torch.as_tensor(lam_per_layer(cfg), dtype=dtype).to(device)
        lam = lam[:, None, None].expand(cfg.nl, cfg.N, cfg.N).contiguous()
    levels = tuple(mg.build_layered_coeffs(nl=cfg.nl, N=cfg.N, L0=cfg.L0,
                                           s=None, lam=lam, dtype=dtype,
                                           device=device))
    return levels, lam


def comp_q(cfg: NewQGConfig, lam: torch.Tensor | None,
           psi: torch.Tensor) -> torch.Tensor:
    """q = lap(psi) + lam psi."""
    q = laplacian(pad(psi, _bc(cfg)), cfg.delta)
    if lam is not None:
        q = q + lam * psi
    return q


def init_state(cfg: NewQGConfig, lam: torch.Tensor | None, *, psi0=None,
               seed=0, generator: torch.Generator | None = None,
               device="cuda") -> NewQGState:
    """psi from `psi0` or 1e-3 uniform noise in [-1, 1] from `generator`
    (default: a CPU generator seeded with `seed`, another stream than the
    JAX package's jax.random draw, so runs that must agree share `psi0`),
    then q = comp_q(psi); on lam's device, else on `device`."""
    dtype = _torch_dtype(cfg)
    if lam is not None:
        device = lam.device
    shape = (cfg.nl, cfg.N, cfg.N)
    if psi0 is None:
        g = generator if generator is not None \
            else torch.Generator().manual_seed(seed)
        psi = 1e-3 * (2.0 * torch.rand(shape, generator=g, device=g.device,
                                       dtype=dtype) - 1.0)
    else:
        psi = torch.as_tensor(psi0, dtype=dtype)
        if tuple(psi.shape) != shape:
            raise ValueError(f"psi0 has shape {tuple(psi.shape)}, the config "
                             f"needs {shape}")
    psi = psi.to(device).contiguous()
    zero = torch.zeros((), dtype=dtype, device=device)
    return NewQGState(q=comp_q(cfg, lam, psi), psi=psi, t=zero,
                      dt_prev=zero.clone(),
                      i=torch.zeros((), dtype=torch.int32, device=device))


def kinetic_energy(cfg: NewQGConfig, psi: torch.Tensor) -> torch.Tensor:
    """Top-layer KE: -sum 0.5 psi lap(psi) Delta^2."""
    p0 = psi[0]
    return -torch.sum(0.5 * p0 * laplacian(pad(p0, _bc(cfg)), cfg.delta)) \
        * cfg.delta ** 2


def make_step(cfg: NewQGConfig, device="cuda"):
    """step(state, tnext) -> (state, NewQGDiag): the predictor-corrector
    step with the constants built here on `device` (the multigrid levels,
    or the spectral solve, and the wind's x-profile). The first inversion
    starts from the last psi, the second from the first's psi; the
    corrector's wind reads the model time of the step's start, as the JAX
    package's does."""
    levels, lam = build_levels(cfg, device)
    dtype = _torch_dtype(cfg)
    bc = _bc(cfg)
    d = cfg.delta
    x = (np.arange(cfg.N) + 0.5) * d
    xrow = torch.as_tensor(x[None, :], dtype=dtype).to(device)
    wind_x = torch.exp(-((xrow - cfg.L0 / 2) ** 2) / 5.0)
    DT = cfg.DT
    fric = cfg.hEkb * cfg.f0 / (2 * cfg.dh[cfg.nl - 1])
    spec = None
    if cfg.solver == "spectral":
        # the layers are uncoupled with a constant coefficient each: the
        # direct solve applies as it is
        spec = spectral.build_spectral(
            nl=cfg.nl, N=cfg.N, L0=cfg.L0, lam=lam_per_layer(cfg),
            periodic=cfg.sbc == -1, dtype=dtype, device=device)
        levels = None

    def forcing(t):
        """The pulse wind (qg.c:69-75): periodic in time, x-localised."""
        return -(cfg.tau0 / cfg.dh[0] * 1.5 * math.pi / cfg.L0
                 * torch.cos(2 * math.pi * t / 5.0) * wind_x)

    def update(q, psi_guess, prev, t):
        if spec is not None:
            psi = spectral.solve_spectral(spec, q)
            st = mg.MGStats(iters=0, resb=0.0, resa=0.0, nrelax=0)
        else:
            psi, st = mg.solve_layered(psi_guess, q, L0=cfg.L0, s=None,
                                       lam=lam, bc=bc,
                                       tolerance=cfg.TOLERANCE,
                                       levels=levels)
        psi_pad = pad(psi, bc)
        zeta = laplacian(psi_pad, d)
        if cfg.sbc == -1:
            zeta_pad = pad(zeta, BC.PERIODIC)
        else:
            zeta_pad = pad_zeta_slip(zeta, psi_pad, cfg.sbc, d)
        # rhs = -J(psi, zeta) - beta v + nu lap(zeta) - hEkb f0/(2 dh) zeta
        # + F (the newqg macro is +J, so -J is msqg's arakawa_mjac)
        dq = arakawa_mjac(psi_pad, zeta_pad, d)
        dq = dq - cfg.beta * (shift(psi_pad, 0, 1)
                              - shift(psi_pad, 0, -1)) / (2 * d)
        dq = dq + cfg.nu * laplacian(zeta_pad, d)
        dq = dq - fric * zeta
        dq = dq + forcing(t)
        # the inline CFL (qg.h:202-219)
        ufx, ufy = face_velocities(psi_pad, d)
        umax = torch.maximum(ufx.abs().max(), ufy.abs().max())
        big = torch.finfo(dtype).max / 4
        dtm = torch.clamp(torch.where(umax > 0, cfg.CFL * d / umax, big),
                          max=DT)
        dtm = torch.where(dtm > prev, (prev + 0.1 * dtm) / 1.1, dtm)
        return dq, psi, dtm, st

    def step(state: NewQGState, tnext):
        dq, psi1, dtm, st = update(state.q, state.psi, state.dt_prev,
                                   state.t)
        dt = dtnext(state.t, tnext, dtm)
        q_half = state.q + dq * (dt / 2)
        dq2, psi2, prev, _ = update(q_half, psi1, dtm, state.t)
        q_new = state.q + dq2 * dt
        new = NewQGState(q=q_new, psi=psi2, t=state.t + dt, dt_prev=prev,
                         i=state.i + 1)
        return new, NewQGDiag(dt=dt, ke=kinetic_energy(cfg, psi2),
                              mg_iters=st.iters)

    return step
