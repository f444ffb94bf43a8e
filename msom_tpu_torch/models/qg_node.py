"""Nodal (vertex-grid) multi-layer QG model, the qg-node family (the port of
the walled part of `msom_tpu.models.qg_node`).

Fields live on the (N+1)^2 vertices with an interior mask; the barotropic
(nl = 1, qg_barotropic.h) and baroclinic multi-layer (qg_baroclinic_ms.h)
modules are config-selected code paths; the meridionally wandering
double-gyre wind is recomputed every step (qg.c:136-145) as a y-profile
from the model time, a 0-d device tensor, with no host read; the walls
take the partial-slip bc_fac ring rules.

Sign conventions are qg-node's, the reverse of msqg's: rhs = -J(psi, zeta)
- J(psi_pg, zeta) - beta psi_x - ..., with J(p, q) the +J Arakawa macro
(qg.h:178-188), which is the port's arakawa_mjac(q, p).

One step (`make_step`) is the predictor-corrector with CFL-controlled dt:
two `update` calls, each a PV inversion, the tendency and the CFL
controller. The inversion is the direct nodal spectral solve (DST-I x
vertical modes, solvers/spectral.build_spectral_node) when the mask is the
default wall rectangle and S2 is horizontally uniform, else the vertex
multigrid (solvers/vmg.py; kernel K6 on the card); solver="vmg" forces the
multigrid. The tendency is kernel K5 (models/fused_node_rhs.py) on a CUDA
tensor whenever S2 varies in y only, its plain version on a CPU tensor, and
the same torch ops on either device for an x-varying S2 (an N2 field).

Not ported yet (each raises NotImplementedError naming its ROADMAP.md item):
the periodic node grid, bc_fac = -1 (item 12b); stochastic forcing (item
12c); the masked wavelet filter event (item 12d). A config with dtflt > 0
builds and steps: only the filter event itself raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from msom_tpu_torch.models import fused_node_rhs
from msom_tpu_torch.models.qg import dtnext
from msom_tpu_torch.ops import vertex
from msom_tpu_torch.ops.stretch import layer_metrics, stretch
from msom_tpu_torch.params import _parse_kv
from msom_tpu_torch.solvers import spectral, vmg
from msom_tpu_torch.solvers.mg import MGStats


@dataclasses.dataclass(frozen=True)
class NodeQGConfig:
    """qg-node configuration (registry defaults, qg-node/qg.h:104-129 and
    qg.c:60-64); the JAX package's fields. `use_pallas` is a JAX-runtime
    knob the port ignores."""
    N: int = 64
    nl: int = 1
    L0: float = 1.0
    f0: float = 1.0
    beta: float = 0.0
    hEkb: float = 0.0
    nu: float = 0.0
    nu4: float = 0.0
    gp_low: float = 0.0
    scale_topo: float = 1.0
    tau0: float = 0.0
    tau1: float = 0.0
    tf1: float = 1.0
    tf2: float = 1.0
    dy_ws: float = 1.0
    forc_mode: float = 2.0
    noise_init: float = 0.0
    Lfmax: float = 1e30
    Lfmin: float = 1e30
    fac_filt_Rd: float = 0.0
    dtflt: float = -1.0
    dh: Tuple[float, ...] = (1.0,)
    N2: Tuple[float, ...] = (1.0,)
    bc_fac: float = 0.0
    flag_ms: int = 0
    DT: float = 1e10
    tend: float = 100.0
    dtout: float = 1.0
    dtdiag: float = -1.0
    CFL: float = 0.5
    TOLERANCE: float = 1e-5
    amp_stoch: float = 0.0
    L_filt_stoch: float = 0.0
    stochastic: bool = False
    use_pallas: bool = True
    solver: str = "auto"     # "auto": the nodal spectral solve where it
    #                          applies, else the vertex multigrid; "vmg"
    #                          forces the multigrid; "spectral" requires
    #                          the spectral solve to apply
    dtype: str = "float32"

    @property
    def delta(self):
        return self.L0 / self.N

    @property
    def iRd2_low(self):
        # qg_barotropic.h:114-118
        if self.gp_low != 0.0:
            return self.f0 ** 2 / (self.gp_low * self.dh[self.nl - 1])
        return 0.0

    @property
    def periodic(self):
        """bc_fac = -1: the doubly periodic node grid (qg-node/qg.c:
        117-121); not ported yet."""
        return self.bc_fac == -1

    def dt_clamped(self):
        """Viscous and beta CFL clamps (qg.h:511-512)."""
        DT = self.DT
        if self.nu != 0:
            DT = 0.5 * min(DT, (self.L0 / self.N) ** 2 / self.nu / 4.0)
        if self.beta != 0:
            DT = min(DT, 1.0 / (2.0 * self.beta * self.L0))
        return DT


_NODE_KEYS = {f.name for f in dataclasses.fields(NodeQGConfig)}


def load_node_config(path_or_text, **overrides) -> NodeQGConfig:
    """A qg-node params.in (a path or the deck's text) as a NodeQGConfig."""
    kv = _parse_kv(path_or_text)
    # the reference keys the stochastic noise scale `L_filt` (qg-node/qg.c:
    # 105-106); amp_stoch != 0 means the stochastic module is on
    if "L_filt" in kv:
        kv.setdefault("L_filt_stoch", float(kv.pop("L_filt")))
    kw = {k: v for k, v in kv.items() if k in _NODE_KEYS}
    if float(kw.get("amp_stoch", 0.0)) != 0.0:
        kw.setdefault("stochastic", True)
    if "dh" in kw and not isinstance(kw["dh"], tuple):
        kw["dh"] = (float(kw["dh"]),)
    if "N2" in kw and not isinstance(kw["N2"], tuple):
        kw["N2"] = (float(kw["N2"]),)
    kw.update(overrides)
    return NodeQGConfig(**kw)


@dataclasses.dataclass(frozen=True)
class NodeQGConstants:
    """Time-independent fields derived at set-up, on one device. `S2_prof`
    is the (nl-1, N+1) y-profile of S2 that kernel K5 reads, None where S2
    varies in x; `vlevels` the multigrid levels where the multigrid runs
    (None with the spectral solve); `has_pg`/`has_topo` say whether psi_pg
    and topo are nonzero, decided at build."""
    mask: torch.Tensor               # (N+1, N+1)
    psi_pg: torch.Tensor             # (nl, N+1, N+1)
    S2: torch.Tensor | None          # (nl-1, N+1, N+1) f_var^2 / N^2
    S2_prof: torch.Tensor | None     # (nl-1, N+1)
    topo: torch.Tensor               # (N+1, N+1)
    q_forcing_3d: torch.Tensor | None
    vlevels: tuple | None
    yv: torch.Tensor                 # (N+1, 1) vertex y-coordinates
    idh0: tuple
    idh1: tuple
    nspec: spectral.SpectralData | None = None
    has_pg: bool = False
    has_topo: bool = False


@dataclasses.dataclass
class NodeQGState:
    q: torch.Tensor                  # (nl, N+1, N+1)
    psi: torch.Tensor
    psi_f: torch.Tensor | None       # filter mean (dtflt > 0)
    t: torch.Tensor                  # 0-d model time
    dt_prev: torch.Tensor            # 0-d CFL controller smoothing state
    i: torch.Tensor                  # 0-d int32 step counter
    nbar: torch.Tensor               # 0-d int32 filter-mean count


class NodeStepDiag(NamedTuple):
    dt: torch.Tensor
    ke: torch.Tensor
    d_ke: torch.Tensor
    f_ke: torch.Tensor
    mg_iters: int                    # V-cycles of the step's first inversion


def _torch_dtype(cfg: NodeQGConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_slice(cfg: NodeQGConfig) -> None:
    """Raise NotImplementedError for a configuration not ported yet."""
    if cfg.periodic:
        raise NotImplementedError(
            "the periodic node grid, bc_fac = -1, is not ported yet "
            "(ROADMAP.md queue 1, item 12b)")
    if cfg.stochastic:
        raise NotImplementedError(
            "qg-node stochastic forcing is not ported yet (ROADMAP.md queue "
            "1, item 12c)")


def coastline_mask(N: int) -> np.ndarray:
    """The curved-coastline interior mask of the repo's masked node
    configuration (bench.py:187-195), a float64 (N+1, N+1) numpy array:
    land west of a wavy coast and on the boundary ring."""
    m = np.ones((N + 1, N + 1))
    y = np.linspace(0, 1, N + 1)
    coast = 0.15 + 0.08 * np.sin(3 * np.pi * y) + 0.05 * np.cos(7 * np.pi * y)
    for j in range(N + 1):
        m[j, : int(coast[j] * N)] = 0.0
    m[0, :] = m[-1, :] = m[:, 0] = m[:, -1] = 0.0
    return m


def build_constants(cfg: NodeQGConfig, *, mask=None, psi_pg=None, N2=None,
                    topo=None, q_forcing_3d=None,
                    device="cuda") -> NodeQGConstants:
    """set_vars and module init (qg.h:404-452, qg_baroclinic_ms.h:449-580)
    on `device`, from the config and the optional numpy inputs: `mask`
    (N+1, N+1), `psi_pg` (nl, N+1, N+1), `N2` an (nl-1, N+1, N+1) field,
    `topo` (N+1, N+1), `q_forcing_3d` (nl, N+1, N+1). The inversion is the
    spectral solve iff solver is "auto" or "spectral", the mask is the
    default rectangle and S2 is horizontally uniform; else the vertex
    multigrid levels are built. The wavelet filter's pyramids are not built
    (its event is not ported)."""
    _check_slice(cfg)
    dtype = _torch_dtype(cfg)
    N, nl = cfg.N, cfg.nl
    M = N + 1
    if nl > 1 and cfg.iRd2_low != 0.0:
        # iRd2_low is a barotropic-module concept (qg_barotropic.h:36,117)
        raise ValueError(
            "iRd2_low (gp_low) is only defined for the barotropic nl == 1 "
            "module (qg_barotropic.h); got nl > 1 with gp_low set")
    if cfg.solver not in ("auto", "spectral", "vmg"):
        raise ValueError(f"solver={cfg.solver!r}: must be 'auto', "
                         "'spectral' or 'vmg'")

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device) \
            .contiguous()

    delta = cfg.delta
    yv = np.arange(M) * delta
    default = np.ones((M, M))
    default[0, :] = default[-1, :] = default[:, 0] = default[:, -1] = 0.0
    mask_np = default if mask is None else np.asarray(mask, np.float64)
    _, idh0, idh1 = layer_metrics(np.asarray(cfg.dh[:nl]))

    S2 = S2_prof = None
    s_uniform = None
    if nl > 1:
        if N2 is None:
            N2a = np.asarray(cfg.N2[:nl - 1], np.float64)[:, None, None] \
                * np.ones((nl - 1, M, M))
        else:
            N2a = np.asarray(N2, np.float64)[:nl - 1]
        # N^2 -> f_var^2 / N^2 (qg_baroclinic_ms.h:498-505), f_var =
        # f0 + flag_ms beta (y - L0/2) (:48); y varies along the rows
        f_var = cfg.f0 + cfg.flag_ms * cfg.beta * (yv[:, None] - 0.5 * cfg.L0)
        S2_np = np.asarray(torch.as_tensor(f_var ** 2 / N2a, dtype=dtype))
        S2 = dev(S2_np)
        if np.array_equal(S2_np, np.broadcast_to(S2_np[..., :1],
                                                 S2_np.shape)):
            S2_prof = dev(S2_np[..., 0])
        if np.all(S2_np == S2_np[:, :1, :1]):
            s_uniform = S2_np[:, 0, 0].astype(np.float64)

    psi_pg_np = np.zeros((nl, M, M)) if psi_pg is None else psi_pg
    topo_np = np.zeros((M, M)) if topo is None else topo
    mask_t = dev(mask_np)
    pp_t, topo_t = dev(psi_pg_np), dev(topo_np) * cfg.scale_topo
    qf3 = None if q_forcing_3d is None else dev(q_forcing_3d)
    for name, t, shape in (("mask", mask_t, (M, M)),
                           ("psi_pg", pp_t, (nl, M, M)),
                           ("topo", topo_t, (M, M)),
                           ("q_forcing_3d", qf3, (nl, M, M))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, the "
                             f"config needs {shape}")

    nspec = vlevels = None
    mask_ok = np.array_equal(mask_np, default)
    if cfg.solver in ("auto", "spectral") and mask_ok \
            and (nl == 1 or s_uniform is not None):
        nspec = spectral.build_spectral_node(
            nl=nl, N=N, L0=cfg.L0, dh=np.asarray(cfg.dh[:nl]),
            s_profile=s_uniform, iRd2_low=cfg.iRd2_low, dtype=dtype,
            device=device)
    elif cfg.solver == "spectral":
        raise ValueError(
            "solver='spectral' needs the default wall mask and "
            "horizontally-uniform S2 (flag_ms=0); use solver='vmg'")
    else:
        vlevels = tuple(vmg.build_vlevels(
            nl=nl, N=N, L0=cfg.L0, S2=S2, idh0=idh0, idh1=idh1,
            iRd2_low=cfg.iRd2_low, mask=mask_t, dtype=dtype))

    return NodeQGConstants(
        mask=mask_t, psi_pg=pp_t, S2=S2, S2_prof=S2_prof, topo=topo_t,
        q_forcing_3d=qf3, vlevels=vlevels,
        yv=dev(yv[:, None]), idh0=tuple(float(v) for v in idh0),
        idh1=tuple(float(v) for v in idh1), nspec=nspec,
        has_pg=bool(nl > 1 and np.any(np.asarray(psi_pg_np))),
        has_topo=bool(np.any(topo_np)))


def comp_q(cfg: NodeQGConfig, const: NodeQGConstants,
           psi: torch.Tensor) -> torch.Tensor:
    """q = lap(psi) + Gamma(psi) (- iRd2_low psi at nl = 1), the ring by
    the partial-slip rule (comp_q_baroclinic :200-211, comp_q_barotropic
    :33-39)."""
    q = vertex.vlap(psi, cfg.delta)
    if cfg.nl > 1:
        q = q + stretch(psi, const.S2, const.idh0, const.idh1)
    else:
        q = q - cfg.iRd2_low * psi
    return vertex.bc_deriv(q, psi, cfg.bc_fac, cfg.delta)


def invert_q(cfg: NodeQGConfig, const: NodeQGConstants,
             psi_guess: torch.Tensor, q: torch.Tensor):
    """PV inversion psi = L^-1 q with a zero ring; returns (psi, MGStats).
    The spectral solve is exact in one shot, reads no guess and reports
    zero cycles; the vertex multigrid is warm-started from psi_guess."""
    if const.nspec is not None:
        psi = torch.zeros_like(q)
        psi[..., 1:-1, 1:-1] = spectral.solve_spectral(
            const.nspec, q[..., 1:-1, 1:-1])
        return psi, MGStats(iters=0, resb=0.0, resa=0.0, nrelax=0)
    psi, st = vmg.vpoisson(psi_guess, q, levels=const.vlevels,
                           idh0=const.idh0, idh1=const.idh1,
                           tolerance=cfg.TOLERANCE)
    return vertex.bc_psi(psi), st


def q_forcing_profile(cfg: NodeQGConfig, y: torch.Tensor,
                      t: torch.Tensor) -> torch.Tensor:
    """The time-varying wandering-gyre wind (event forcing, qg.c:136-145)
    on the y values `y`; t a 0-d tensor (no host read)."""
    amp = -(cfg.tau0 + cfg.tau1 * torch.cos(2 * math.pi * t / cfg.tf1)) \
        / cfg.dh[0] * cfg.forc_mode * math.pi / cfg.L0
    arg = cfg.forc_mode * math.pi * (
        y + y * (y - cfg.L0) * 2 / (cfg.L0 ** 2) * cfg.dy_ws
        * torch.sin(2 * math.pi * t / cfg.tf2)) / cfg.L0
    return amp * torch.sin(arg)


def q_forcing_field(cfg: NodeQGConfig, const: NodeQGConstants,
                    t: torch.Tensor) -> torch.Tensor:
    """The wind as an (N+1, 1) column, which broadcasts against the
    (N+1, N+1) vertex grid (it is constant in x)."""
    return q_forcing_profile(cfg, const.yv, t)


def rhs_pv(cfg: NodeQGConfig, const: NodeQGConstants, q: torch.Tensor,
           psi: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """rhs_pv_baroclinic (qg_baroclinic_ms.h:103-196) / rhs_pv_barotropic
    (qg_barotropic.h:16-29): kernel K5 (fused_node_rhs.rhs_fused_node) when
    S2 varies in y only (always at nl = 1), else the same torch ops on
    either device."""
    qf = q_forcing_profile(cfg, const.yv[:, 0], t)
    if cfg.nl == 1 or const.S2_prof is not None:
        return fused_node_rhs.rhs_fused_node(cfg, const, q, psi, qf)
    return fused_node_rhs.rhs_node_reference(cfg, const, q, psi, qf)


def adjust_dt(cfg: NodeQGConfig, psi: torch.Tensor, dtmax0: float,
              prev: torch.Tensor):
    """adjust_dt (qg.h:258-284): the face speed from nodal psi differences,
    the previous-dt smoothing; returns (dtm, new prev), 0-d tensors."""
    d = cfg.delta
    u1 = torch.abs(psi[..., 1:, :] - psi[..., :-1, :]) / d
    u2 = torch.abs(psi[..., :, 1:] - psi[..., :, :-1]) / d
    umax = torch.maximum(u1.max(), u2.max())
    big = torch.finfo(psi.dtype).max / 4
    dtm = torch.clamp(torch.where(umax > 0, cfg.CFL * d / umax, big),
                      max=dtmax0)
    dtm = torch.where(dtm > prev, (prev + 0.1 * dtm) / 1.1, dtm)
    return dtm, dtm


def init_state(cfg: NodeQGConfig, const: NodeQGConstants, *, psi0=None,
               seed=0, generator: torch.Generator | None = None
               ) -> NodeQGState:
    """Initial conditions: psi from `psi0`, or noise_init * (uniform noise
    in [-1, 1] + sin(2 pi y / L0)) from `generator` (default: a CPU
    generator seeded with `seed`, a different stream from the JAX
    package's jax.random draw, so runs that must agree share `psi0`); the
    ring set to zero, then q = comp_q(psi)."""
    dtype, device = const.mask.dtype, const.mask.device
    M = cfg.N + 1
    if psi0 is None:
        g = generator if generator is not None \
            else torch.Generator().manual_seed(seed)
        noise = 2.0 * torch.rand((cfg.nl, M, M), generator=g,
                                 device=g.device, dtype=dtype) - 1.0
        psi = cfg.noise_init * (noise.to(device) + torch.sin(
            2 * math.pi * const.yv / cfg.L0))
    else:
        psi = torch.as_tensor(psi0, dtype=dtype).to(device)
    psi = vertex.bc_psi(psi)
    zero = torch.zeros((), dtype=dtype, device=device)
    izero = torch.zeros((), dtype=torch.int32, device=device)
    return NodeQGState(
        q=comp_q(cfg, const, psi), psi=psi,
        psi_f=torch.zeros_like(psi) if cfg.dtflt > 0 else None, t=zero,
        dt_prev=zero.clone(), i=izero, nbar=izero.clone())


def diag_1d(cfg: NodeQGConfig, const: NodeQGConstants, psi: torch.Tensor,
            q: torch.Tensor, t: torch.Tensor):
    """(ke, d_ke, f_ke) of the top layer as write_1d_diag (qg.h:381-390)
    computes them; 0-d tensors."""
    d2 = cfg.delta ** 2
    p0 = psi[0]
    lap_psi = vertex.vlap(p0, cfg.delta)
    lap_q = vertex.vlap(q[0], cfg.delta)
    qf = q_forcing_field(cfg, const, t)
    ke = -torch.sum(0.5 * p0 * lap_psi) * d2
    d_ke = -cfg.nu * torch.sum(p0 * lap_q) * d2
    f_ke = -torch.sum(p0 * qf) * d2
    return ke, d_ke, f_ke


def make_step(cfg: NodeQGConfig):
    """step(state, const, tnext) -> (state, NodeStepDiag): one predictor-
    corrector step: dt from the CFL-limited first update clamped by
    dtnext, a half-step Euler predictor, the corrector's update at the
    midpoint (with the model time of the step's start, as the reference
    evaluates the wind), and the full step. The first inversion starts
    from the last psi, the second from the first's psi."""
    DT = cfg.dt_clamped()

    def update(const, q, psi_guess, prev, t):
        psi, st = invert_q(cfg, const, psi_guess, q)
        dq = rhs_pv(cfg, const, q, psi, t)
        dtm, prev = adjust_dt(cfg, psi, DT, prev)
        return dq, psi, prev, dtm, st

    def step(state: NodeQGState, const: NodeQGConstants, tnext):
        dq, psi1, prev, dtm, st = update(const, state.q, state.psi,
                                         state.dt_prev, state.t)
        dt = dtnext(state.t, tnext, dtm)
        q_half = state.q + dq * (dt / 2)
        dq2, psi2, prev, _, _ = update(const, q_half, psi1, prev, state.t)
        q_new = state.q + dq2 * dt
        ke, d_ke, f_ke = diag_1d(cfg, const, psi2, q_new, state.t)
        new = NodeQGState(q=q_new, psi=psi2, psi_f=state.psi_f,
                          t=state.t + dt, dt_prev=prev, i=state.i + 1,
                          nbar=state.nbar)
        return new, NodeStepDiag(dt=dt, ke=ke, d_ke=d_ke, f_ke=f_ke,
                                 mg_iters=st.iters)

    return step


def generate_noise(cfg, const, generator, shape):
    """Spatially correlated stochastic forcing (qg-node/qg_stochastic.h):
    not ported yet."""
    raise NotImplementedError(
        "qg-node stochastic forcing is not ported yet (ROADMAP.md queue 1, "
        "item 12c)")


def wavelet_filter(cfg, const, state):
    """The masked wavelet filter event with its eddy/mean split
    (qg_baroclinic_ms.h:345-400): not ported yet."""
    raise NotImplementedError(
        "the masked wavelet filter event is not ported yet (ROADMAP.md "
        "queue 1, item 12d)")
