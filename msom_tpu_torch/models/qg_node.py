"""Nodal (vertex-grid) multi-layer QG model, the qg-node family (the port of
`msom_tpu.models.qg_node`).

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

bc_fac = -1 is the doubly periodic node grid (qg-node/qg.c:117-121): the
state drops to the N independent nodes a side, every operator wraps, the
inversion is the cell-grid periodic multigrid (solvers/mg.solve_layered)
and the tendency is torch ops on either device (K5 has no periodic mode).
With `stochastic` the step adds spatially correlated noise
(qg_stochastic.h): a white normal draw from a torch.Generator, high-passed
by the wavelet pyramid (`generate_noise`). `wavelet_filter` is the masked
wavelet filter event with its eddy/mean split (qg_baroclinic_ms.h:345-400),
torch ops on the field's device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from msom_tpu_torch.models import fused_node_rhs
from msom_tpu_torch.models.qg import dtnext
from msom_tpu_torch.ops import vertex
from msom_tpu_torch.ops.bc import BC, pad
from msom_tpu_torch.ops.ghost import arakawa_mjac_g, ghosted, laplacian_g
from msom_tpu_torch.ops.stretch import layer_metrics, stretch
from msom_tpu_torch.ops.wavelet import (inverse_wavelet, sig_lev_pyramid,
                                        wavelet)
from msom_tpu_torch.params import _parse_kv
from msom_tpu_torch.solvers import mg, spectral, vmg
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
        117-121), N independent nodes a side (node N is node 0), so the
        state is (nl, N, N) and every operator wraps."""
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
    (None with the spectral solve; the cell-grid periodic levels on the
    periodic grid); `has_pg`/`has_topo` say whether psi_pg and topo are
    nonzero, decided at build. With the filter (dtflt > 0) `sig_lev_c` is
    the low-pass pyramid on the centred (N, N) grid and `mask_c` the
    fractional centred-mask pyramid (walled only); with stochastic forcing
    and L_filt_stoch > 0 `sig_noise` is the noise's high-pass pyramid. The
    periodic grid has no mask (None) and its fields are (.., N, N)."""
    mask: torch.Tensor | None        # (N+1, N+1)
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
    sig_lev_c: tuple | None = None   # (2^l, 2^l), l = 0..log2 N
    mask_c: tuple | None = None
    sig_noise: tuple | None = None


@dataclasses.dataclass
class NodeQGState:
    q: torch.Tensor                  # (nl, N+1, N+1); periodic (nl, N, N)
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


def _stratification(cfg: NodeQGConfig, N2, npts: int, dtype):
    """S2 = f_var^2 / N^2 (qg_baroclinic_ms.h:498-505) as a numpy array of
    the working type, (nl-1, npts, npts), from the config's N2 or an N2
    field; f_var = f0 + flag_ms beta (y - L0/2) (:48), y along the rows.
    None at nl = 1."""
    nl = cfg.nl
    if nl == 1:
        return None
    if N2 is None:
        N2a = np.asarray(cfg.N2[:nl - 1], np.float64)[:, None, None] \
            * np.ones((nl - 1, npts, npts))
    else:
        N2a = np.asarray(N2, np.float64)[:nl - 1]
    y = np.arange(npts) * cfg.delta
    f_var = cfg.f0 + cfg.flag_ms * cfg.beta * (y[:, None] - 0.5 * cfg.L0)
    return np.asarray(torch.as_tensor(f_var ** 2 / N2a, dtype=dtype))


def _pyramids(cfg: NodeQGConfig, S2_np, mask_np, dev):
    """(sig_lev_c, mask_c, sig_noise) on the centred (N, N) grid, each a
    tuple of tensors by level or None. The filter's low-pass weights come
    from the cutoff scale lf: min(fac_filt_Rd dh0 / sqrt(S2 averaged to
    cells), Lfmax) where fac_filt_Rd > 0 (walled), else the y-ramp from
    Lfmax at y = 0 to Lfmin at y = L0 (qg_baroclinic_ms.h:536-559). mask_c
    (walled) is the 4-vertex average of the mask, then 4-cell restrictions
    (:563-578): fractional, not 0/1. The noise's weights are the high-pass
    complement at the scale L_filt_stoch (qg_stochastic.h)."""
    N = cfg.N
    sig_lev_c = mask_c = sig_noise = None
    if (cfg.dtflt > 0 or (cfg.stochastic and cfg.L_filt_stoch > 0)) \
            and N & (N - 1):
        raise ValueError(f"N = {N}: the filter's and the noise's wavelet "
                         "pyramids need N a power of 2")
    if cfg.dtflt > 0:
        xc = (np.arange(N) + 0.5) * cfg.delta
        Yc = np.broadcast_to(xc[:, None], (N, N))
        if cfg.fac_filt_Rd > 0 and mask_np is not None:
            if S2_np is None:
                raise ValueError("fac_filt_Rd > 0 takes the deformation "
                                 "radius of the first interface: nl > 1")
            s = S2_np[0]
            S2c = 0.25 * (s[:-1, :-1] + s[1:, :-1] + s[:-1, 1:] + s[1:, 1:])
            lf = np.minimum(cfg.fac_filt_Rd * cfg.dh[0] / np.sqrt(S2c),
                            cfg.Lfmax)
        else:
            lf = cfg.Lfmax + (Yc / cfg.L0) * (cfg.Lfmin - cfg.Lfmax)
        sig_lev_c = tuple(dev(s) for s in
                          sig_lev_pyramid(lf, cfg.L0, highpass=False))
        if mask_np is not None:
            m = mask_np
            pyr = [0.25 * (m[:-1, :-1] + m[1:, :-1] + m[:-1, 1:]
                           + m[1:, 1:])]
            for _ in range(int(round(np.log2(N)))):
                m = pyr[-1]
                pyr.append(0.25 * (m[::2, ::2] + m[1::2, ::2] + m[::2, 1::2]
                                   + m[1::2, 1::2]))
            mask_c = tuple(dev(m) for m in reversed(pyr))
    if cfg.stochastic and cfg.L_filt_stoch > 0:
        sig_noise = tuple(dev(s) for s in sig_lev_pyramid(
            np.full((N, N), cfg.L_filt_stoch), cfg.L0, highpass=True))
    return sig_lev_c, mask_c, sig_noise


def build_constants(cfg: NodeQGConfig, *, mask=None, psi_pg=None, N2=None,
                    topo=None, q_forcing_3d=None,
                    device="cuda") -> NodeQGConstants:
    """set_vars and module init (qg.h:404-452, qg_baroclinic_ms.h:449-580)
    on `device`, from the config and the optional numpy inputs: `mask`
    (N+1, N+1), `psi_pg` (nl, N+1, N+1), `N2` an (nl-1, N+1, N+1) field,
    `topo` (N+1, N+1), `q_forcing_3d` (nl, N+1, N+1). The inversion is the
    spectral solve iff solver is "auto" or "spectral", the mask is the
    default rectangle and S2 is horizontally uniform; else the vertex
    multigrid levels are built. The periodic grid (bc_fac = -1) goes to
    `build_constants_periodic`."""
    if cfg.periodic:
        if mask is not None and not np.all(np.asarray(mask) == 1.0):
            raise ValueError(
                "periodic (bc_fac = -1) configs have no walls: a mask other "
                "than all ones cannot be applied")
        return build_constants_periodic(cfg, psi_pg=psi_pg, N2=N2,
                                        topo=topo, q_forcing_3d=q_forcing_3d,
                                        device=device)
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
    S2_np = _stratification(cfg, N2, M, dtype)
    if S2_np is not None:
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

    sig_lev_c, mask_c, sig_noise = _pyramids(
        cfg, S2_np, np.asarray(torch.as_tensor(mask_np, dtype=dtype)), dev)
    return NodeQGConstants(
        mask=mask_t, psi_pg=pp_t, S2=S2, S2_prof=S2_prof, topo=topo_t,
        q_forcing_3d=qf3, vlevels=vlevels,
        yv=dev(yv[:, None]), idh0=tuple(float(v) for v in idh0),
        idh1=tuple(float(v) for v in idh1), nspec=nspec,
        has_pg=bool(nl > 1 and np.any(np.asarray(psi_pg_np))),
        has_topo=bool(np.any(topo_np)), sig_lev_c=sig_lev_c, mask_c=mask_c,
        sig_noise=sig_noise)


def build_constants_periodic(cfg: NodeQGConfig, *, psi_pg=None, N2=None,
                             topo=None, q_forcing_3d=None,
                             device="cuda") -> NodeQGConstants:
    """The periodic grid's constants (bc_fac = -1): fields on the N owned
    nodes a side (psi_pg (nl, N, N); topo and q_forcing_3d may be given on
    the (N+1)^2 vertex view, whose last row and column are dropped), no
    mask, and the cell-grid periodic multigrid's levels
    (mg.build_layered_coeffs) with the barotropic Helmholtz shift
    -iRd2_low where gp_low is set (nl = 1 only: comp_q subtracts it only
    there, so a layered shift would de-pair the inversion from comp_q)."""
    dtype = _torch_dtype(cfg)
    N, nl = cfg.N, cfg.nl

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device) \
            .contiguous()

    _, idh0, idh1 = layer_metrics(np.asarray(cfg.dh[:nl]))
    S2_np = _stratification(cfg, N2, N, dtype)
    S2 = None if S2_np is None else dev(S2_np)
    psi_pg_np = np.zeros((nl, N, N)) if psi_pg is None else psi_pg
    topo_np = np.zeros((N, N)) if topo is None \
        else np.asarray(topo)[..., :N, :N]
    pp_t = dev(psi_pg_np)
    if tuple(pp_t.shape) != (nl, N, N):
        raise ValueError(f"psi_pg has shape {tuple(pp_t.shape)}, the "
                         f"periodic config needs {(nl, N, N)}")
    lam = None
    if cfg.iRd2_low != 0.0:
        if nl > 1:
            raise ValueError(
                "iRd2_low (gp_low) is only defined for the barotropic "
                "nl == 1 module (qg_barotropic.h); got periodic nl > 1")
        lam = torch.full((nl, N, N), -cfg.iRd2_low, dtype=dtype,
                         device=device)
    clevels = mg.build_layered_coeffs(nl=nl, N=N, L0=cfg.L0, s=S2,
                                      idh0=idh0, idh1=idh1, lam=lam,
                                      dtype=dtype, device=device)
    sig_lev_c, _, sig_noise = _pyramids(cfg, S2_np, None, dev)
    return NodeQGConstants(
        mask=None, psi_pg=pp_t, S2=S2, S2_prof=None,
        topo=dev(topo_np) * cfg.scale_topo,
        q_forcing_3d=None if q_forcing_3d is None
        else dev(np.asarray(q_forcing_3d)[..., :N, :N]),
        vlevels=tuple(clevels), yv=dev((np.arange(N) * cfg.delta)[:, None]),
        idh0=tuple(float(v) for v in idh0),
        idh1=tuple(float(v) for v in idh1),
        has_pg=bool(nl > 1 and np.any(np.asarray(psi_pg_np))),
        has_topo=bool(np.any(topo_np)), sig_lev_c=sig_lev_c,
        sig_noise=sig_noise)


def _project_nullspace(cfg: NodeQGConfig, f: torch.Tensor) -> torch.Tensor:
    """Remove the periodic operator's nullspace component, the global
    constant across layers (left nullvector: the dh weights), the analogue
    of zeroing the barotropic k = 0 mode; nothing with the Helmholtz
    shift, which has no nullspace."""
    if cfg.iRd2_low != 0.0:
        return f
    w = torch.as_tensor(cfg.dh[:cfg.nl], dtype=f.dtype, device=f.device)
    wbar = torch.einsum("l,lyx->", w, f) / (w.sum() * f.shape[-1]
                                            * f.shape[-2])
    return f - wbar


def _wrap_lap(f: torch.Tensor, delta: float) -> torch.Tensor:
    return laplacian_g(ghosted(f, BC.PERIODIC), delta)


def comp_q(cfg: NodeQGConfig, const: NodeQGConstants,
           psi: torch.Tensor) -> torch.Tensor:
    """q = lap(psi) + Gamma(psi) (- iRd2_low psi at nl = 1), the ring by
    the partial-slip rule (comp_q_baroclinic :200-211, comp_q_barotropic
    :33-39); periodic: wrapping, no ring."""
    lap = _wrap_lap(psi, cfg.delta) if cfg.periodic \
        else vertex.vlap(psi, cfg.delta)
    if cfg.nl > 1:
        q = lap + stretch(psi, const.S2, const.idh0, const.idh1)
    else:
        q = lap - cfg.iRd2_low * psi
    if cfg.periodic:
        return q
    return vertex.bc_deriv(q, psi, cfg.bc_fac, cfg.delta)


def invert_q(cfg: NodeQGConfig, const: NodeQGConstants,
             psi_guess: torch.Tensor, q: torch.Tensor):
    """PV inversion psi = L^-1 q; returns (psi, MGStats). Walled: a zero
    ring; the spectral solve is exact in one shot, reads no guess and
    reports zero cycles, the vertex multigrid is warm-started from
    psi_guess. Periodic: the cell-grid periodic multigrid from psi_guess on
    q and psi without their nullspace component."""
    if cfg.periodic:
        psi, st = mg.solve_layered(
            psi_guess, _project_nullspace(cfg, q), L0=cfg.L0,
            idh0=const.idh0, idh1=const.idh1, bc=BC.PERIODIC,
            tolerance=cfg.TOLERANCE, levels=const.vlevels)
        return _project_nullspace(cfg, psi), st
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
    """The wind as a (rows, 1) column, which broadcasts against the node
    grid (it is constant in x)."""
    return q_forcing_profile(cfg, const.yv, t)


def _rhs_pv_periodic(cfg: NodeQGConfig, const: NodeQGConstants,
                     q: torch.Tensor, psi: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
    """rhs_pv on the N-node periodic grid: the walled terms with wrapping
    ghosts and without any boundary rule (no mask, no bc_deriv)."""
    d, nl = cfg.delta, cfg.nl

    def G(f):
        return ghosted(f, BC.PERIODIC)

    def J(p, qq):
        return arakawa_mjac_g(G(qq), G(p), d)

    def betaterm(p):
        return cfg.beta * (torch.roll(p, -1, -1) - torch.roll(p, 1, -1)) \
            / (2 * d)

    qf = q_forcing_field(cfg, const, t)
    if nl == 1:
        return (-J(psi, q) - betaterm(psi)
                - cfg.hEkb * cfg.f0 / (2 * cfg.dh[nl - 1]) * q
                + qf[None] + cfg.nu * laplacian_g(G(q), d))
    zeta = laplacian_g(G(psi), d)
    pp = const.psi_pg if const.has_pg else None
    dq = -J(psi, zeta)
    if pp is not None:
        dq = dq - J(pp, zeta)
    dq = dq - betaterm(psi)
    Jd = J(psi[:-1], psi[1:])
    if pp is not None:
        Jd = Jd + J(pp[:-1], psi[1:]) + J(psi[:-1], pp[1:])
    idh0 = torch.tensor(const.idh0, dtype=q.dtype,
                        device=q.device).reshape(nl, 1, 1)
    idh1 = torch.tensor(const.idh1, dtype=q.dtype,
                        device=q.device).reshape(nl, 1, 1)
    dq[:-1] += -const.S2 * Jd * idh1[:-1]
    dq[1:] += const.S2 * Jd * idh0[1:]
    bottom = -cfg.hEkb * cfg.f0 / (2 * cfg.dh[nl - 1]) * zeta[nl - 1]
    if const.has_topo:
        bottom = bottom - J(psi[nl - 1], const.topo) * cfg.f0 \
            / cfg.dh[nl - 1]
    dq[nl - 1] += bottom
    dq = dq + cfg.nu * stretch(zeta, const.S2, const.idh0, const.idh1)
    tmp = laplacian_g(G(zeta), d)
    dq = dq + cfg.nu * tmp
    if cfg.nu4 != 0.0:
        dq = dq - cfg.nu4 * (stretch(tmp, const.S2, const.idh0, const.idh1)
                             + laplacian_g(G(tmp), d))
    dq[0] += qf
    if const.q_forcing_3d is not None:
        dq = dq + const.q_forcing_3d
    return dq


def rhs_pv(cfg: NodeQGConfig, const: NodeQGConstants, q: torch.Tensor,
           psi: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """rhs_pv_baroclinic (qg_baroclinic_ms.h:103-196) / rhs_pv_barotropic
    (qg_barotropic.h:16-29): kernel K5 (fused_node_rhs.rhs_fused_node) when
    S2 varies in y only (always at nl = 1), else the same torch ops on
    either device; the periodic grid's torch ops on either device."""
    if cfg.periodic:
        return _rhs_pv_periodic(cfg, const, q, psi, t)
    qf = q_forcing_profile(cfg, const.yv[:, 0], t)
    if cfg.nl == 1 or const.S2_prof is not None:
        return fused_node_rhs.rhs_fused_node(cfg, const, q, psi, qf)
    return fused_node_rhs.rhs_node_reference(cfg, const, q, psi, qf)


def adjust_dt(cfg: NodeQGConfig, psi: torch.Tensor, dtmax0: float,
              prev: torch.Tensor):
    """adjust_dt (qg.h:258-284): the face speed from nodal psi differences
    (wrapping on the periodic grid), the previous-dt smoothing; returns
    (dtm, new prev), 0-d tensors."""
    d = cfg.delta
    if cfg.periodic:
        u1 = torch.abs(torch.roll(psi, -1, -2) - psi) / d
        u2 = torch.abs(torch.roll(psi, -1, -1) - psi) / d
    else:
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
    ring set to zero (periodic: the nullspace component removed), then
    q = comp_q(psi)."""
    dtype, device = const.yv.dtype, const.yv.device
    n = cfg.N if cfg.periodic else cfg.N + 1
    if psi0 is None:
        g = generator if generator is not None \
            else torch.Generator().manual_seed(seed)
        noise = 2.0 * torch.rand((cfg.nl, n, n), generator=g,
                                 device=g.device, dtype=dtype) - 1.0
        psi = cfg.noise_init * (noise.to(device) + torch.sin(
            2 * math.pi * const.yv / cfg.L0))
    else:
        psi = torch.as_tensor(psi0, dtype=dtype).to(device)
    psi = _project_nullspace(cfg, psi) if cfg.periodic \
        else vertex.bc_psi(psi)
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
    lap = _wrap_lap if cfg.periodic else vertex.vlap
    lap_psi = lap(p0, cfg.delta)
    lap_q = lap(q[0], cfg.delta)
    qf = q_forcing_field(cfg, const, t)
    ke = -torch.sum(0.5 * p0 * lap_psi) * d2
    d_ke = -cfg.nu * torch.sum(p0 * lap_q) * d2
    f_ke = -torch.sum(p0 * qf) * d2
    return ke, d_ke, f_ke


def to_vertex_full(cfg: NodeQGConfig, a: torch.Tensor) -> torch.Tensor:
    """Periodic (.., N, N) owned nodes -> the (.., N+1, N+1) vertex view
    that the reference's NetCDF layout stores (node N is node 0); the
    field itself on a walled grid."""
    if not cfg.periodic:
        return a
    a = torch.cat([a, a[..., :1, :]], dim=-2)
    return torch.cat([a, a[..., :, :1]], dim=-1)


def draw_white(cfg: NodeQGConfig, const: NodeQGConstants,
               generator: torch.Generator, shape) -> torch.Tensor:
    """The white part of the stochastic forcing: a standard normal draw of
    `shape` from `generator` (on the constants' device) times amp_stoch. A
    different stream from the JAX package's jax.random draw: the two agree
    in distribution only."""
    g, d = generator.device, const.yv.device
    if g.type != d.type or (None not in (g.index, d.index)
                            and g.index != d.index):
        raise ValueError(f"the noise generator is on {g}, the model on {d}")
    return torch.randn(shape, generator=generator, device=d,
                       dtype=const.yv.dtype) * cfg.amp_stoch


def filter_noise(cfg: NodeQGConfig, const: NodeQGConstants,
                 white: torch.Tensor) -> torch.Tensor:
    """Spatial correlation of a white field (qg-node/qg_stochastic.h):
    average to the centred grid, transform, damp the large scales with the
    high-pass weights of L_filt_stoch (BC.NEUMANN walled, BC.PERIODIC),
    rebuild and average back to the nodes (edge-padded, then times the
    mask, on walls). With L_filt_stoch <= 0 the white field itself."""
    if const.sig_noise is None:
        return white

    def high_pass(c, bc):
        w = wavelet(c, bc)
        return inverse_wavelet(tuple(wl * sl for wl, sl in
                                     zip(w, const.sig_noise)), bc)

    if cfg.periodic:
        def r(a, k, ax):
            return torch.roll(a, k, ax)
        wc = 0.25 * (white + r(white, -1, -2) + r(white, -1, -1)
                     + r(r(white, -1, -2), -1, -1))
        filt = high_pass(wc, BC.PERIODIC)
        return 0.25 * (filt + r(filt, 1, -2) + r(filt, 1, -1)
                       + r(r(filt, 1, -2), 1, -1))
    wc = 0.25 * (white[..., :-1, :-1] + white[..., 1:, :-1]
                 + white[..., :-1, 1:] + white[..., 1:, 1:])
    fc = pad(high_pass(wc, BC.NEUMANN), BC.NEUMANN)    # edge padding
    vtx = 0.25 * (fc[..., :-1, :-1] + fc[..., 1:, :-1]
                  + fc[..., :-1, 1:] + fc[..., 1:, 1:])
    return vtx * const.mask


def generate_noise(cfg: NodeQGConfig, const: NodeQGConstants,
                   generator: torch.Generator, shape) -> torch.Tensor:
    """One step's spatially correlated stochastic forcing
    (qg-node/qg_stochastic.h): `filter_noise` of a `draw_white`."""
    return filter_noise(cfg, const, draw_white(cfg, const, generator, shape))


def make_step(cfg: NodeQGConfig, generator: torch.Generator | None = None):
    """step(state, const, tnext) -> (state, NodeStepDiag): one predictor-
    corrector step: dt from the CFL-limited first update clamped by
    dtnext, a half-step Euler predictor, the corrector's update at the
    midpoint (with the model time of the step's start, as the reference
    evaluates the wind), and the full step. The first inversion starts
    from the last psi, the second from the first's psi.

    With cfg.stochastic the step adds the Euler-Maruyama kick: one
    `generate_noise` a step from `generator` (required, on the state's
    device), shared by the predictor (x sqrt(dt)/2) and the corrector
    (x sqrt(dt))."""
    DT = cfg.dt_clamped()
    if cfg.stochastic and generator is None:
        raise ValueError("a stochastic step needs a torch.Generator on the "
                         "state's device")

    def update(const, q, psi_guess, prev, t):
        psi, st = invert_q(cfg, const, psi_guess, q)
        dq = rhs_pv(cfg, const, q, psi, t)
        dtm, prev = adjust_dt(cfg, psi, DT, prev)
        return dq, psi, prev, dtm, st

    def step(state: NodeQGState, const: NodeQGConstants, tnext):
        dq, psi1, prev, dtm, st = update(const, state.q, state.psi,
                                         state.dt_prev, state.t)
        dt = dtnext(state.t, tnext, dtm)
        noise = generate_noise(cfg, const, generator, state.q.shape) \
            if cfg.stochastic else None
        q_half = state.q + dq * (dt / 2)
        if noise is not None:
            q_half = q_half + noise * torch.sqrt(dt) / 2.0
        dq2, psi2, prev, _, _ = update(const, q_half, psi1, prev, state.t)
        q_new = state.q + dq2 * dt
        if noise is not None:
            q_new = q_new + noise * torch.sqrt(dt)
        ke, d_ke, f_ke = diag_1d(cfg, const, psi2, q_new, state.t)
        new = NodeQGState(q=q_new, psi=psi2, psi_f=state.psi_f,
                          t=state.t + dt, dt_prev=prev, i=state.i + 1,
                          nbar=state.nbar)
        return new, NodeStepDiag(dt=dt, ke=ke, d_ke=d_ke, f_ke=f_ke,
                                 mg_iters=st.iters)

    return step


def wavelet_filter(cfg: NodeQGConfig, const: NodeQGConstants,
                   state: NodeQGState) -> NodeQGState:
    """The masked wavelet filter event with its eddy/mean split
    (wavelet_filter, qg_baroclinic_ms.h:345-400): re-invert psi, average
    it to the centred grid, transform (BC.DIRICHLET with the mask pyramid
    mask_c; periodic: BC.PERIODIC), keep the large scales with the
    low-pass sig_lev_c, rebuild and average back to the nodes: psi_loc.
    psi_f accumulates psi_loc / dtflt as a running mean over the events
    (nbar so far); psi <- (psi - psi_loc) mask and q = comp_q(psi)."""
    psi, _ = invert_q(cfg, const, state.psi, state.q)

    def low_pass(c, bc, mask_c):
        w = wavelet(c, bc, mask_c)
        return inverse_wavelet(tuple(wl * sl for wl, sl in
                                     zip(w, const.sig_lev_c)), bc, mask_c)

    if cfg.periodic:
        def r(a, k, ax):
            return torch.roll(a, k, ax)
        pc = 0.25 * (psi + r(psi, -1, -2) + r(psi, -1, -1)
                     + r(r(psi, -1, -2), -1, -1))
        pl = low_pass(pc, BC.PERIODIC, None)
        psi_loc = 0.25 * (r(r(pl, 1, -2), 1, -1) + r(pl, 1, -1)
                          + r(pl, 1, -2) + pl)
        psi_new = psi - psi_loc
    else:
        # vertices -> cells (:369-371), cells -> vertices (:385)
        pc = 0.25 * (psi[..., :-1, :-1] + psi[..., 1:, :-1]
                     + psi[..., :-1, 1:] + psi[..., 1:, 1:])
        plp = F.pad(low_pass(pc, BC.DIRICHLET, const.mask_c), (1, 1, 1, 1))
        psi_loc = 0.25 * (plp[..., :-1, :-1] + plp[..., 1:, :-1]
                          + plp[..., :-1, 1:] + plp[..., 1:, 1:])
        psi_new = (psi - psi_loc) * const.mask
    psi_f = (state.psi_f * state.nbar + psi_loc / cfg.dtflt) \
        / (state.nbar + 1)
    return dataclasses.replace(state, psi=psi_new,
                               q=comp_q(cfg, const, psi_new), psi_f=psi_f,
                               nbar=state.nbar + 1)
