"""Surface QG, the qg-node family's variant with a prognostic surface
buoyancy (the port of `msom_tpu.models.sqg`, which completes the design
that the reference's unfinished qg-node/sqg_baroclinic_ms.h sketches).

* The surface buoyancy `bs` is an extra prognostic field on the (N+1)^2
  vertex grid.
* SQG layer metrics: idh0[0] = 1/dh[0], idh1[0] = 1/(dhc[0] dh[0])
  (sqg_baroclinic_ms.h:500-509); surface S2[0] = f/N^2[0], interfaces
  S2[l] = f^2/N^2[l] (:544-549).
* The top layer's stretching S2[0] bs idh0[0] - S2[1] (psi0 - psi1) idh1[0]
  (comp_stretch, :77-98) is split into its psi part, which the inversion
  operator holds, and the known bs source, moved to the right-hand side,
  so the vertex multigrid (solvers/vmg.py, kernel K6 on the card) runs
  unchanged.
* The prognostic PV q leaves the bs source out (q = lap(psi) +
  Gamma_psi(psi)); bs carries it:
      dbs/dt = -J(psi_0 + psi_pg_0, bs) + nu lap(bs) - nu4 lap^2(bs)
  with homogeneous Neumann walls and the interior mask.
* dq/dt is the baroclinic rhs_pv with the SQG interface metrics. As in the
  JAX package, the node constants that `_node_const` makes have no nodal
  spectral solve and no profile for the fused tendency, so rhs_pv runs
  the plain torch ops (`fused_node_rhs.rhs_node_reference`) on either
  device, not kernel K5.

bs == 0 reduces to models.qg_node's baroclinic path with the SQG
metrics. The walled grid only (bc_fac != -1).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from msom_tpu_torch.models import qg_node as node
from msom_tpu_torch.models.qg import dtnext
from msom_tpu_torch.ops import vertex
from msom_tpu_torch.ops.stencil import arakawa_mjac
from msom_tpu_torch.solvers import vmg


@dataclasses.dataclass(frozen=True)
class SQGConstants:
    """Time-independent fields on one device. `has_pg` and `has_topo` say
    whether psi_pg and topo are nonzero, decided at build."""
    mask: torch.Tensor           # (N+1, N+1)
    psi_pg: torch.Tensor         # (nl, N+1, N+1)
    S2: torch.Tensor             # (nl, N+1, N+1): [0] f/N^2, [1:] f^2/N^2
    topo: torch.Tensor           # (N+1, N+1)
    vlevels: tuple               # vertex multigrid levels of the psi part
    yv: torch.Tensor             # (N+1, 1) vertex y-coordinates
    idh0: tuple                  # SQG metrics: idh0[0] = 1/dh[0]
    idh1: tuple
    has_pg: bool = False
    has_topo: bool = False


@dataclasses.dataclass
class SQGState:
    q: torch.Tensor              # (nl, N+1, N+1)
    bs: torch.Tensor             # (N+1, N+1) surface buoyancy
    psi: torch.Tensor
    t: torch.Tensor              # 0-d model time
    dt_prev: torch.Tensor        # 0-d CFL smoothing state
    i: torch.Tensor              # 0-d int32 step counter


class SQGStepDiag(NamedTuple):
    dt: torch.Tensor
    ke: torch.Tensor
    bs2: torch.Tensor            # surface buoyancy variance
    mg_iters: int                # V-cycles of the step's first inversion


def sqg_metrics(dh):
    """(idh0, idh1) with the SQG surface convention
    (sqg_baroclinic_ms.h:500-509)."""
    dh = np.asarray(dh, np.float64)
    nl = len(dh)
    dhc = 0.5 * (dh[:-1] + dh[1:])
    idh0 = np.zeros(nl)
    idh1 = np.zeros(nl)
    idh0[0] = 1.0 / dh[0]
    if nl > 1:
        idh1[0] = 1.0 / (dhc[0] * dh[0])
        for l in range(1, nl - 1):
            idh0[l] = 1.0 / (dhc[l - 1] * dh[l])
            idh1[l] = 1.0 / (dhc[l] * dh[l])
        idh0[nl - 1] = 1.0 / (dhc[nl - 2] * dh[nl - 1])
    return idh0, idh1


def build_constants(cfg: node.NodeQGConfig, *, mask=None, psi_pg=None,
                    N2=None, topo=None, device="cuda") -> SQGConstants:
    """The constants on `device` from the config and the optional numpy
    inputs: `mask` (N+1, N+1), `psi_pg` (nl, N+1, N+1), `N2` an (nl, N+1,
    N+1) field (else cfg.N2, which must have nl entries: N2[0] at the
    surface, N2[1:] at the nl-1 interior interfaces), `topo` (N+1, N+1)."""
    if cfg.nl < 2:
        raise ValueError("the SQG variant needs nl >= 2")
    if cfg.periodic:
        raise ValueError("the SQG variant has walls (bc_fac != -1)")
    dtype = node._torch_dtype(cfg)
    N, nl = cfg.N, cfg.nl
    M = N + 1

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device) \
            .contiguous()

    yv = np.arange(M) * cfg.delta
    mask_t = vertex.default_mask(N, dtype, device) if mask is None \
        else dev(mask)
    idh0, idh1 = sqg_metrics(cfg.dh[:nl])
    pp_np = np.zeros((nl, M, M)) if psi_pg is None else np.asarray(psi_pg)
    if N2 is None:
        if len(cfg.N2) < nl:
            raise ValueError(f"SQG needs nl = {nl} N2 values (the surface "
                             f"and the interfaces), the config has "
                             f"{len(cfg.N2)}")
        N2a = np.asarray(cfg.N2[:nl], np.float64)[:, None, None] \
            * np.ones((nl, M, M))
    else:
        N2a = np.asarray(N2, np.float64)[:nl]
    f_var = cfg.f0 + cfg.flag_ms * cfg.beta * (yv[:, None] - 0.5 * cfg.L0)
    S2 = np.empty_like(N2a)
    S2[0] = f_var / N2a[0]              # surface: f/N^2 (:544-549)
    S2[1:] = f_var ** 2 / N2a[1:]       # interfaces: f^2/N^2
    S2 = dev(S2)
    topo_np = np.zeros((M, M)) if topo is None else np.asarray(topo)
    for name, a, shape in (("mask", mask_t, (M, M)),
                           ("psi_pg", pp_np, (nl, M, M)),
                           ("topo", topo_np, (M, M))):
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, the "
                             f"config needs {shape}")
    # the inversion couples the layers through the interface values S2[1:]
    # with no top coupling (t0[0] = 0 in relax_baroclinic,
    # sqg_baroclinic_ms.h:286-292): the layered operator with the metrics
    # (0, idh0[1:]) and idh1
    idh0_c = np.r_[0.0, idh0[1:]]
    vlevels = tuple(vmg.build_vlevels(
        nl=nl, N=N, L0=cfg.L0, S2=S2[1:], idh0=idh0_c, idh1=idh1,
        iRd2_low=0.0, mask=mask_t, dtype=dtype))
    return SQGConstants(
        mask=mask_t, psi_pg=dev(pp_np), S2=S2,
        topo=dev(topo_np) * cfg.scale_topo, vlevels=vlevels,
        yv=dev(yv[:, None]), idh0=tuple(float(v) for v in idh0),
        idh1=tuple(float(v) for v in idh1), has_pg=bool(np.any(pp_np)),
        has_topo=bool(np.any(topo_np)))


def _node_const(cfg, const: SQGConstants) -> node.NodeQGConstants:
    """The SQG constants as baroclinic NodeQGConstants with the psi
    coupling metrics (no top idh0): rhs_pv and the inversion reuse the
    node model's. No nodal spectral solve and no S2 profile, as in the JAX
    package (its nspec and nrhsk stay None)."""
    return node.NodeQGConstants(
        mask=const.mask, psi_pg=const.psi_pg, S2=const.S2[1:], S2_prof=None,
        topo=const.topo, q_forcing_3d=None, vlevels=const.vlevels,
        yv=const.yv, idh0=(0.0,) + const.idh0[1:], idh1=const.idh1,
        has_pg=const.has_pg, has_topo=const.has_topo)


def bs_source(cfg, const: SQGConstants, bs: torch.Tensor) -> torch.Tensor:
    """S2[0] bs idh0[0] in the top layer: the known part of the stretching
    (comp_stretch's upper-layer bs term, sqg_baroclinic_ms.h:84)."""
    src = const.S2[0] * bs * const.idh0[0]
    zeros = torch.zeros((cfg.nl - 1,) + tuple(bs.shape), dtype=bs.dtype,
                        device=bs.device)
    return torch.cat([src[None], zeros], dim=0)


def comp_q(cfg, const: SQGConstants, psi: torch.Tensor,
           bs: torch.Tensor) -> torch.Tensor:
    """q with the bs stretching (comp_q_baroclinic + comp_stretch)."""
    return node.comp_q(cfg, _node_const(cfg, const), psi) \
        + bs_source(cfg, const, bs)


def invert_q(cfg, const: SQGConstants, psi_guess: torch.Tensor,
             q: torch.Tensor, bs: torch.Tensor):
    """(psi, MGStats): lap(psi) + Gamma_psi(psi) = q - bs_source."""
    return node.invert_q(cfg, _node_const(cfg, const), psi_guess,
                         q - bs_source(cfg, const, bs))


def _lap_neumann(b: torch.Tensor, d: float) -> torch.Tensor:
    P = F.pad(b[None], (1, 1, 1, 1), mode="replicate")[0]
    return (P[2:, 1:-1] + P[:-2, 1:-1] + P[1:-1, 2:] + P[1:-1, :-2]
            - 4.0 * b) / (d * d)


def rhs_bs(cfg, const: SQGConstants, psi: torch.Tensor,
           bs: torch.Tensor) -> torch.Tensor:
    """dbs/dt = -J(psi_0 + psi_pg_0, bs) + nu lap(bs) - nu4 lap^2(bs),
    Neumann walls, masked interior (the completed rhs_bs)."""
    d = cfg.delta
    ps = psi[0] + const.psi_pg[0]
    db = -F.pad(arakawa_mjac(bs, ps, d), (1, 1, 1, 1))
    if cfg.nu != 0.0:
        db = db + cfg.nu * _lap_neumann(bs, d)
    if cfg.nu4 != 0.0:
        db = db - cfg.nu4 * _lap_neumann(_lap_neumann(bs, d), d)
    return db * const.mask


def init_state(cfg, const: SQGConstants, *, psi0=None, bs0=None, seed=0,
               generator: torch.Generator | None = None) -> SQGState:
    """psi from `psi0` and bs from `bs0`, else noise_init * uniform noise
    in [-1, 1] from `generator` (default: a CPU generator seeded with
    `seed`; another stream than the JAX package's draw, so runs that must
    agree share psi0 and bs0), bs masked; psi's ring set to zero, then
    q = comp_q(psi, bs)."""
    dtype, device = const.yv.dtype, const.yv.device
    M = cfg.N + 1
    g = generator if generator is not None \
        else torch.Generator().manual_seed(seed)

    def noise(shape):
        return cfg.noise_init * (2.0 * torch.rand(
            shape, generator=g, device=g.device, dtype=dtype) - 1.0)

    psi = noise((cfg.nl, M, M)) if psi0 is None \
        else torch.as_tensor(psi0, dtype=dtype)
    psi = vertex.bc_psi(psi.to(device))
    if bs0 is None:
        bs = noise((M, M)).to(device) * const.mask
    else:
        bs = torch.as_tensor(bs0, dtype=dtype).to(device)
    zero = torch.zeros((), dtype=dtype, device=device)
    return SQGState(q=comp_q(cfg, const, psi, bs), bs=bs, psi=psi, t=zero,
                    dt_prev=zero.clone(),
                    i=torch.zeros((), dtype=torch.int32, device=device))


def make_step(cfg: node.NodeQGConfig):
    """step(state, const, tnext) -> (state, SQGStepDiag): the predictor-
    corrector advancing q and bs together (the node model's scheme: the
    corrector reads the model time of the step's start)."""
    DT = cfg.dt_clamped()
    d2 = cfg.delta ** 2

    def update(const, q, bs, psi_guess, prev, t):
        psi, st = invert_q(cfg, const, psi_guess, q, bs)
        dq = node.rhs_pv(cfg, _node_const(cfg, const), q, psi, t)
        db = rhs_bs(cfg, const, psi, bs)
        dtm, prev = node.adjust_dt(cfg, psi, DT, prev)
        return dq, db, psi, prev, dtm, st

    def step(state: SQGState, const: SQGConstants, tnext):
        dq, db, psi1, prev, dtm, st = update(const, state.q, state.bs,
                                             state.psi, state.dt_prev,
                                             state.t)
        dt = dtnext(state.t, tnext, dtm)
        q_half = state.q + dq * (dt / 2)
        bs_half = state.bs + db * (dt / 2)
        dq2, db2, psi2, prev, _, _ = update(const, q_half, bs_half, psi1,
                                            prev, state.t)
        q_new = state.q + dq2 * dt
        bs_new = state.bs + db2 * dt
        ke = -torch.sum(0.5 * psi2[0] * vertex.vlap(psi2[0], cfg.delta)) \
            * d2
        bs2 = torch.sum(bs_new ** 2) * d2
        new = SQGState(q=q_new, bs=bs_new, psi=psi2, t=state.t + dt,
                       dt_prev=prev, i=state.i + 1)
        return new, SQGStepDiag(dt=dt, ke=ke, bs2=bs2, mg_iters=st.iters)

    return step
