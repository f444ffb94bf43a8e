"""Multi-layer quasi-geostrophic model, msqg (the port of
`msom_tpu.models.qg`, with the direct spectral inversion or the multigrid).

One step is Basilisk's predictor-corrector with CFL-controlled adaptive dt
(`make_step`): two `update` calls, each a PV inversion, the fused RHS and,
with passive tracers, the fused tracer tendency (the Hopper kernels on a
CUDA tensor, their plain PyTorch versions on a CPU tensor) and the scalar
CFL tail. The scalar tail stays on the device as 0-d tensors; with the
spectral solver a step makes no host sync, with solver="mg" each V-cycle
brings its residual norm to the host (`solvers/mg.py`).

The multigrid inversion (solver="mg") is warm-started: from the last psi,
or with mg_extrap from 2 psi - psi_old (`QGState.psi_old`). With
mode_pv_invert it solves nl independent Helmholtz problems in the vertical
modes instead of the layer-coupled system.

Ported: free-slip and partial-slip walls (sbc >= 0) and the doubly
periodic domain (sbc = -1: psi, q, the derived fields and the tracers wrap;
the large-scale streamfunction keeps the reference's non-wrap ghost law and
the topography its Neumann ghosts), the large-scale (PG) streamfunction
coupling from `psipg` or `upg/vpg`, _LS_RV (flsrv = 1), bottom topography,
the 3-D forcing `qforc`, ENERGY_CONSERV advection, passive tracers with an
optional relaxation field, stochastic forcing (Euler-Maruyama, noise
from a `torch.Generator` that the caller gives `make_step`), and the
Froude-number field `frpg` of the PG coupling, and the variable Rossby
number (varRo: Ro = Rom / (1 + Rom beta (y - L0/2)), so strl = (Fr/Ro)^2
and the topography's 1/(Ro dh) vary in y). A strl that varies in y only
keeps the fused tendency and the multigrid's y-profile levels, and with
solver="spectral" it takes the y-profile direct solve (solvers/vary.py:
the DST in x, then block-Thomas sweeps in y, kernel KV on the card). A
strl that varies in x is no mode of the fused tendency (nor of the JAX
package's kernel, pallas_rhs.strl_profile): such a configuration runs
`rhs` as torch ops on either device, decided once at build
(`QGConstants.rhs_kernel`), its multigrid levels carry full fields (no K3
or K4), and it has no direct solve. The wavelet
filter's constants (the cutoff scale sig_filt from `rdpg` or the modal
deformation radius, and the sig_lev pyramid) and its state leaves (the
filter-mean PV flux `qof` and its count `nbar`) are built here; the filter
event itself is `ops/wavelet.wavelet_filter_step`, fired by `driver.run_qg`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from msom_tpu_torch.models import fused_rhs, fused_tracer
from msom_tpu_torch.ops.bc import BC, pad
from msom_tpu_torch.ops.ghost import (Ghosted, arakawa_mjac_g, beta_effect_g,
                                      ghosted, ghosted_from_padded,
                                      ghosted_slip, laplacian_g,
                                      max_face_speed_layers)
from msom_tpu_torch.ops.modes import eigmod
from msom_tpu_torch.ops.stencil import laplacian
from msom_tpu_torch.ops.stretch import layer_metrics, stretch
from msom_tpu_torch.ops.wavelet import sig_lev_pyramid
from msom_tpu_torch.params import QGConfig
from msom_tpu_torch.solvers import mg, spectral, vary


@dataclasses.dataclass(frozen=True)
class QGConstants:
    """Time-independent fields derived at setup (set_const, reference
    msqg/qg.h:931-1116), on one device, under the JAX package's names.
    wind and Ro (varRo) vary in y only here, and so does strl unless a
    frpg input varies in x, so they are kept as contiguous y-profiles with
    a unit x axis: they broadcast against (nl, N, N) fields, and the fused
    RHS kernel reads them as they are. An x-varying strl is a full field, and
    `rhs_kernel` is then False: the tendency runs as torch ops. `pp`, `topo`
    and `iro` are what the fused kernels read beside the padded fields: the
    contiguous interiors (the kernels apply the ghost rules themselves) and
    the y-profile 1/(Ro dh_bottom). In the periodic run, whose pp and
    zetap ghosts are data, the kernel reads `pp_t` and `zetap_t` instead:
    pp_pad and zetap_pad with three zero columns on either side, so that
    its 16-byte copies of their rows stay aligned (the role of the JAX
    package's pre-tiled pp_t and zetap_t, pallas_rhs.py:234-243)."""
    strl: torch.Tensor | None     # (nl-1, N, 1) or (nl-1, N, N) (Fr/Ro)^2
    wind: torch.Tensor            # (N, 1) surface forcing term for layer 0
    idh0: tuple                   # host floats (layer metrics)
    idh1: tuple
    # direct inversion: the modal spectral solve, or with a strl that
    # varies in y only the y-profile solve
    spec: spectral.SpectralData | vary.VarySpectralData | None
    Ro: torch.Tensor | None = None          # (N, 1) Rossby number
    pp_pad: torch.Tensor | None = None      # (nl, N+2, N+2) large-scale psi
    zetap_pad: torch.Tensor | None = None   # (nl, N+2, N+2) lap(pp), flsrv
    topo_pad: torch.Tensor | None = None    # (N+2, N+2) bottom topography
    qforc: torch.Tensor | None = None       # (nl, N, N) 3-D forcing
    ptr_relax: torch.Tensor | None = None   # (nl, nptr, N, N)
    umax_pp: torch.Tensor | None = None     # (nl,) face-speed maxima of pp
    pp: torch.Tensor | None = None          # (nl, N, N) interior of pp_pad
    pp_t: torch.Tensor | None = None        # (nl, N+2, N+8), periodic run
    zetap_t: torch.Tensor | None = None     # (nl, N+2, N+8), periodic flsrv
    topo: torch.Tensor | None = None        # (N, N) interior of topo_pad
    iro: torch.Tensor | None = None         # (N, 1) 1/(Ro dh[nl-1]), topo
    s_stoch: torch.Tensor | None = None     # (nl, N, N) noise amplitude
    levels: tuple | None = None             # multigrid levels, solver="mg"
    iBu: torch.Tensor | None = None         # (nl, N, 1|N) -1/Rd^2 per mode
    # layers -> modes and back: (nl, nl), or (N, nl, nl) a row, or
    # (N, N, nl, nl) a column where strl varies in y, in x and y
    l2m: torch.Tensor | None = None
    m2l: torch.Tensor | None = None
    mlevels: tuple | None = None            # levels of the modal solves
    sig_lev: tuple | None = None            # (2^l, 2^l) high-pass weights
    sig_filt: torch.Tensor | None = None    # (N, N) min(afilt Rd, Lfmax)
    Rd: torch.Tensor | None = None          # (N, N) its deformation radius
    rhs_kernel: bool = True                 # strl a y-profile: K1 runs


@dataclasses.dataclass
class QGState:
    q: torch.Tensor               # (nl, N, N) potential vorticity
    psi: torch.Tensor             # (nl, N, N) streamfunction
    t: torch.Tensor               # 0-d model time
    dt_prev: torch.Tensor         # 0-d CFL controller smoothing state
    i: torch.Tensor               # 0-d int32 step counter
    tracers: torch.Tensor | None = None   # (nl, nptr, N, N)
    psi_old: torch.Tensor | None = None   # psi one step back (mg_extrap)
    qof: torch.Tensor | None = None       # (nl, N, N) filter-mean PV flux
    nbar: torch.Tensor | None = None      # 0-d int32 filter events in qof


class StepDiag(NamedTuple):
    dt: torch.Tensor
    ke: torch.Tensor              # surface-layer kinetic energy
    mg_iters: int                 # V-cycles of the step's first inversion
    mg_res: float                 # its final residual max-norm


def _torch_dtype(cfg: QGConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _bc_psi(cfg: QGConfig) -> BC:
    """The ghost law of psi, q, the derived fields and (periodic) the
    tracers."""
    return BC.PERIODIC if cfg.sbc == -1 else BC.DIRICHLET


def _check_slice(cfg: QGConfig) -> None:
    """Raise ValueError for a wall law that the model does not have."""
    if cfg.sbc < 0 and cfg.sbc != -1:
        raise ValueError(f"sbc = {cfg.sbc}: -1 (doubly periodic) or >= 0 "
                         "(walls)")


def build_constants(cfg: QGConfig, *, device="cuda", fused_mm: bool = False,
                    psipg=None, topo=None, qforc=None, dh=None,
                    ptr_relax=None, s_stoch=None, rdpg=None,
                    frpg=None) -> QGConstants:
    """Derive the static model fields on `device`. The optional arrays
    override the defaults as the reference's input files do (psipg_*.bas
    etc., msqg/qg.h:950-985): `psipg` (nl, N, N) large-scale streamfunction
    (else vpg*x - upg*y from the config), `topo` (N, N), `qforc` (nl, N, N),
    `dh` (nl,) layer thicknesses, `ptr_relax` (nl, nptr, N, N), `s_stoch`
    (nl, N, N) the stochastic noise amplitude (else 1), `rdpg` (N, N) the
    deformation radius that sets the filter scale (else 1; with
    mode_pv_invert the first baroclinic mode's radius), `frpg` (nl-1 or
    more, N, N) the Froude numbers of the interfaces (else the config's
    Fr; its first nl-1 blocks are read). `fused_mm`
    routes the inversion through the fused basis-matmul solve (the matmul
    transform; 128 <= N <= 1024, N % 128 == 0; the spectral solver only).
    With solver="mg" the multigrid levels are built here instead of the
    spectral data, and with mode_pv_invert the vertical modes and the
    levels of the modal Helmholtz solves (one eigensolve a distinct
    column: one, one a row of y, or one a cell)."""
    _check_slice(cfg)
    if fused_mm and cfg.solver != "spectral":
        raise ValueError("fused_mm is an option of solver='spectral'")
    dtype = _torch_dtype(cfg)
    nl, N = cfg.nl, cfg.N
    dh = np.asarray(dh if dh is not None else cfg.dh[:nl], np.float64)
    _, idh0, idh1 = layer_metrics(dh)

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    y = (np.arange(N, dtype=np.float64) + 0.5) * cfg.delta   # cell centres

    # large-scale streamfunction pp = vpg*x - upg*y (msqg/qg.h:904-909);
    # without one every J(., pp) term is pruned (pp_pad None)
    upg, vpg = np.zeros(nl), np.zeros(nl)
    upg[:len(cfg.upg[:nl])] = cfg.upg[:nl]
    vpg[:len(cfg.vpg[:nl])] = cfg.vpg[:nl]
    pp_pad = zetap_pad = pp = umax_pp = pp_t = zetap_t = None
    if psipg is not None or np.any(upg) or np.any(vpg):
        if psipg is not None:
            pp_np = np.asarray(psipg, np.float64)
        else:
            pp_np = (vpg[:, None, None] * y[None, None, :]
                     - upg[:, None, None] * y[None, :, None])
        if pp_np.shape != (nl, N, N):
            raise ValueError(f"psipg has shape {pp_np.shape}, the config "
                             f"needs {(nl, N, N)}")
        pp = dev(pp_np)
        if cfg.sbc == -1:
            pp_pad = dev(_periodic_pp_pad(cfg, pp_np, upg, vpg, y))
        else:
            pp_pad = pad(pp, BC.DIRICHLET)
        # large-scale relative vorticity (_LS_RV, msqg/qg.h:1094-1096); its
        # ghosts wrap in the periodic run, unlike pp's
        if cfg.flsrv == 1:
            zetap_pad = pad(laplacian(pp_pad, cfg.delta), _bc_psi(cfg))
        # pp is constant in time: its part of the CFL chain
        # (msqg/qg.h:387-390) is computed once here
        umax_pp = max_face_speed_layers(ghosted_from_padded(pp_pad),
                                        cfg.delta)
        if cfg.sbc == -1:
            pp_t = F.pad(pp_pad, (3, 3)).contiguous()
            if zetap_pad is not None:
                zetap_t = F.pad(zetap_pad, (3, 3)).contiguous()

    # the Rossby number, with varRo a y-profile (msqg/qg.h:1032-1037)
    if cfg.varRo > 0:
        Ro_np = cfg.Rom / (1.0 + cfg.Rom * cfg.beta * (y - 0.5 * cfg.L0))
    else:
        Ro_np = np.full(N, float(cfg.Rom))
    Ro_np = Ro_np[:, None]
    Ro = dev(Ro_np)
    strl = s_np = None
    rhs_kernel = True
    if nl > 1:
        # strl = (Fr/Ro)^2 at the nl-1 interfaces (msqg/qg.h:1043-1048)
        if frpg is not None:
            Fr = np.asarray(frpg, np.float64)
            if Fr.ndim != 3 or Fr.shape[0] < nl - 1 \
                    or Fr.shape[1:] != (N, N):
                raise ValueError(f"frpg has shape {Fr.shape}, the config "
                                 f"needs {(nl - 1, N, N)} or more blocks")
            Fr = Fr[:nl - 1]
        else:
            Fr = np.asarray(cfg.Fr[:nl - 1], np.float64)[:, None, None]
        # at the working precision, as the JAX package's routing and modal
        # solves read it
        s_np = torch.as_tensor((Fr / Ro_np) ** 2, dtype=dtype) \
            .double().numpy()
        rhs_kernel = bool(np.array_equal(
            s_np, np.broadcast_to(s_np[..., :1], s_np.shape)))
        s_np = np.broadcast_to(s_np[..., :1] if rhs_kernel else s_np,
                               (nl - 1, N, 1 if rhs_kernel else N))
        strl = dev(np.array(s_np)).contiguous()

    # surface forcing (msqg/qg.h:446-459): dq0 -= wind; wind varies in y
    wind = dev(cfg.tau0 / (cfg.Rom * dh[0]) * np.sin(2 * np.pi * y / cfg.L0)
               * np.sin(np.pi * y / cfg.L0))[:, None]

    topo_pad = topo_in = iro = None
    if topo is not None:
        topo_in = dev(topo)
        if tuple(topo_in.shape) != (N, N):
            raise ValueError(f"topo has shape {tuple(topo_in.shape)}, the "
                             f"config needs {(N, N)}")
        topo_pad = pad(topo_in, BC.NEUMANN)
        iro = dev(1.0 / (Ro_np * float(cfg.dh[nl - 1])))

    def field(a, name, shape):
        if a is None:
            return None
        a = dev(a)
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, the "
                             f"config needs {shape}")
        return a.contiguous()

    # vertical modes (MODE_PV_INVERT, msqg/qg.h:109-157): one eigensolve
    # a distinct column, as the JAX package decides (qg.py:198-219): one
    # for a uniform strl, one a row of y, or one a cell
    vm = iBu_np = Rd_modal = None
    if cfg.mode_pv_invert and nl > 1:
        s3 = np.broadcast_to(s_np, (nl - 1, N, N))
        if np.allclose(s3, s3[:, :1, :1]):
            vm = eigmod(dh, s3[:, 0, 0])
            iBu_np = vm.iBu[:, None, None] * np.ones((1, N, 1))
            Rd_modal = float(vm.Rd[1]) * np.ones((N, N))
        elif np.allclose(s3, s3[..., :1]):
            vm = eigmod(dh, np.moveaxis(s3[..., 0], 0, -1))
            iBu_np = np.moveaxis(vm.iBu, -1, 0)[..., None]
            Rd_modal = np.repeat(vm.Rd[:, 1][:, None], N, axis=1)
        else:
            vm = eigmod(dh, np.moveaxis(s3, 0, -1))
            iBu_np = np.moveaxis(vm.iBu, -1, 0)
            Rd_modal = vm.Rd[..., 1]

    # the wavelet filter's scale sig_filt = min(afilt Rd, Lfmax) and, with
    # the filter on, its per-level high-pass weights (msqg/qg.h:1052-1090):
    # Rd is 1, or the rdpg input, or with mode_pv_invert the first
    # baroclinic radius (JAX qg.py:226-237, which builds the weights for
    # every config)
    Rd = np.ones((N, N)) if rdpg is None else np.asarray(rdpg, np.float64)
    if Rd.shape != (N, N):
        raise ValueError(f"rdpg has shape {Rd.shape}, the config needs "
                         f"{(N, N)}")
    if Rd_modal is not None:
        Rd = Rd_modal
    sig_filt = np.minimum(cfg.afilt * Rd, cfg.Lfmax)
    sig_lev = None
    if cfg.dtflt > 0:
        # the pyramid halves N down to one cell
        if N & (N - 1):
            raise ValueError(f"the wavelet filter (dtflt > 0) needs N a "
                             f"power of 2, not {N}")
        sig_lev = tuple(dev(s_) for s_ in sig_lev_pyramid(sig_filt, cfg.L0))

    spec = levels = iBu = l2m = m2l = mlevels = None
    if cfg.solver == "spectral" and s_np is not None \
            and not np.all(s_np == s_np[:, :1, :1]):
        # strl varies: the y-profile direct solve (DST in x, block Thomas
        # in y), for walls and a strl constant along x only
        if not rhs_kernel or cfg.sbc == -1:
            raise ValueError(
                "solver='spectral' requires stretching uniform or varying "
                "in y only, walled BCs (x-varying frpg or periodic varRo: "
                "use solver='mg')")
        if fused_mm:
            raise ValueError("fused_mm needs a uniform stretching (the "
                             "y-profile solve has no basis-matmul form)")
        spec = vary.build_spectral_vary(
            nl=nl, N=N, L0=cfg.L0, s_prof=s_np[:, :, 0], idh0=idh0,
            idh1=idh1, dtype=dtype, transform=cfg.transform, device=device)
    elif cfg.solver == "spectral":
        spec = spectral.build_spectral(
            nl=nl, N=N, L0=cfg.L0, dh=dh,
            s_profile=None if s_np is None else s_np[:, 0, 0],
            periodic=cfg.sbc == -1,
            dtype=dtype, transform="matmul" if fused_mm else cfg.transform,
            fused_mm=fused_mm, device=device)
    elif vm is not None:
        iBu = dev(iBu_np).contiguous()
        l2m, m2l = dev(vm.l2m), dev(vm.m2l)
        mlevels = tuple(mg.build_layered_coeffs(
            nl=nl, N=N, L0=cfg.L0, s=None, lam=iBu, dtype=dtype))
    else:
        levels = tuple(mg.build_layered_coeffs(
            nl=nl, N=N, L0=cfg.L0, s=strl, idh0=idh0, idh1=idh1,
            dtype=dtype, device=device))
    return QGConstants(
        strl=strl, wind=wind, idh0=tuple(float(v) for v in idh0),
        idh1=tuple(float(v) for v in idh1), spec=spec, Ro=Ro,
        pp_pad=pp_pad, zetap_pad=zetap_pad, topo_pad=topo_pad,
        qforc=field(qforc, "qforc", (nl, N, N)),
        ptr_relax=field(ptr_relax, "ptr_relax", (nl, cfg.nptr, N, N)),
        s_stoch=field(s_stoch, "s_stoch", (nl, N, N)),
        umax_pp=umax_pp, pp=pp, pp_t=pp_t, zetap_t=zetap_t, topo=topo_in,
        iro=iro, levels=levels,
        iBu=iBu, l2m=l2m, m2l=m2l, mlevels=mlevels, sig_lev=sig_lev,
        sig_filt=dev(sig_filt), Rd=dev(Rd), rhs_kernel=rhs_kernel)


def _periodic_pp_pad(cfg: QGConfig, pp: np.ndarray, upg: np.ndarray,
                     vpg: np.ndarray, y: np.ndarray) -> np.ndarray:
    """pp padded for the periodic run (msqg/qg.h:1105-1114): the ghosts do
    not wrap; each is 2 (vpg x - upg y) at the boundary face minus the
    interior cell beside it, x first, then y on the x-padded rows (the
    JAX package's `build_constants`, qg.py:143-157)."""
    nl, N = pp.shape[0], cfg.N
    out = np.zeros((nl, N + 2, N + 2))
    out[:, 1:-1, 1:-1] = pp
    u, v = upg[:, None], vpg[:, None]
    out[:, 1:-1, 0] = -2 * u * y - pp[:, :, 0]                  # x = 0
    out[:, 1:-1, -1] = 2 * (v * cfg.L0 - u * y) - pp[:, :, -1]  # x = L0
    xpad = np.concatenate([[y[0] - cfg.delta], y, [y[-1] + cfg.delta]])
    out[:, 0, :] = 2 * v * xpad - out[:, 1, :]                   # y = 0
    out[:, -1, :] = 2 * (v * xpad - u * cfg.L0) - out[:, -2, :]  # y = L0
    return out


def comp_q(cfg: QGConfig, const: QGConstants, psi: torch.Tensor):
    """q = lap(psi) + Gamma(psi) (comp_q, msqg/qg.h:396-403)."""
    q = laplacian_g(ghosted(psi, _bc_psi(cfg)), cfg.delta)
    if cfg.nl > 1:
        q = q + stretch(psi, const.strl, const.idh0, const.idh1)
    return q


def invert_q(cfg: QGConfig, const: QGConstants,
             psi_guess: torch.Tensor | None, q: torch.Tensor):
    """PV inversion psi = L^-1 q, warm-started from `psi_guess` (invertq,
    msqg/qg.h:113-163); returns (psi, MGStats).

    The spectral path solves the discrete system exactly in one shot, reads
    no guess and reports zero cycles and a zero residual. The modal path
    (mode_pv_invert) projects q and the guess onto the vertical modes,
    solves the nl independent 2-D Helmholtz problems in one batched
    multigrid (no vertical coupling: the line solve is a diagonal) and
    projects back."""
    if const.spec is not None:
        if isinstance(const.spec, vary.VarySpectralData):
            psi = vary.solve_spectral_vary(const.spec, q)
        else:
            psi = spectral.solve_spectral(const.spec, q)
        return psi, mg.MGStats(iters=0, resb=0.0, resa=0.0, nrelax=0)
    if const.mlevels is not None:
        cols = {2: "", 3: "y", 4: "yx"}[const.l2m.ndim]
        qm = torch.einsum(f"{cols}ml,lyx->myx", const.l2m, q)
        pm_guess = torch.einsum(f"{cols}ml,lyx->myx", const.l2m, psi_guess)
        pm, st = mg.solve_layered(pm_guess, qm, L0=cfg.L0, s=None,
                                  lam=const.iBu, bc=_bc_psi(cfg),
                                  tolerance=cfg.tol, levels=const.mlevels)
        return torch.einsum(f"{cols}lm,myx->lyx", const.m2l, pm), st
    return mg.solve_layered(psi_guess, q, L0=cfg.L0, s=const.strl,
                            idh0=const.idh0, idh1=const.idh1,
                            bc=_bc_psi(cfg), tolerance=cfg.tol,
                            levels=const.levels)


def init_state(cfg: QGConfig, const: QGConstants, *, psi0=None, seed=0,
               tracers0=None,
               generator: torch.Generator | None = None) -> QGState:
    """Initial conditions: psi from `psi0` or 1e-3 uniform noise in
    [-1, 1], made zero-mean per layer, then q = comp_q(psi) (reference
    msqg/qg.c:53-92); with nptr > 0 the tracers from `tracers0` or the same
    kind of noise; with dtflt > 0 a zero filter mean qof (nbar = 0). The
    noise comes from `generator` (default: a CPU
    generator seeded with `seed`); it is a different stream from the JAX
    package's jax.random draw, so runs that must agree share `psi0` and
    `tracers0`."""
    dtype, device = const.wind.dtype, const.wind.device
    g = generator if generator is not None \
        else torch.Generator().manual_seed(seed)

    def noise(shape):
        return 1e-3 * (2.0 * torch.rand(shape, generator=g, device=g.device,
                                        dtype=dtype) - 1.0)

    shape = (cfg.nl, cfg.N, cfg.N)
    psi = noise(shape) if psi0 is None else torch.as_tensor(psi0, dtype=dtype)
    psi = psi.to(device)
    psi = psi - psi.mean(dim=(-2, -1), keepdim=True)
    tracers = None
    if cfg.nptr > 0:
        tshape = (cfg.nl, cfg.nptr, cfg.N, cfg.N)
        tracers = noise(tshape) if tracers0 is None \
            else torch.as_tensor(tracers0, dtype=dtype)
        if tuple(tracers.shape) != tshape:
            raise ValueError(f"tracers0 has shape {tuple(tracers.shape)}, "
                             f"the config needs {tshape}")
        tracers = tracers.to(device).contiguous()
    zero = torch.zeros((), dtype=dtype, device=device)
    # the mg warm start extrapolates from two steps (guess = 2 psi -
    # psi_old); psi_old starts as psi, so the first guess is psi itself
    psi_old = psi if cfg.solver == "mg" and cfg.mg_extrap else None
    q = comp_q(cfg, const, psi)
    qof = nbar = None
    if cfg.dtflt > 0:
        qof = torch.zeros_like(q)
        nbar = torch.zeros((), dtype=torch.int32, device=device)
    return QGState(q=q, psi=psi, t=zero, dt_prev=zero.clone(),
                   i=torch.zeros((), dtype=torch.int32, device=device),
                   tracers=tracers, psi_old=psi_old, qof=qof, nbar=nbar)


# ---------------------------------------------------------------------------
# RHS assembly
# ---------------------------------------------------------------------------

def _ghost_deriv(cfg: QGConfig, field: torch.Tensor,
                 parent_g: Ghosted) -> Ghosted:
    """Ghosts of a Laplacian-derived field (comp_del2, msqg/qg.h:183-198):
    a wrap in the periodic run; at a wall the Dirichlet rule applied to the
    derived field's own interior, not recomputed from its parent's ghosts,
    with the partial-slip overwrite of the edge ghosts relative to the
    parent when sbc > 0."""
    if cfg.sbc == -1:
        return ghosted(field, BC.PERIODIC)
    return ghosted_slip(field, parent_g, cfg.sbc, cfg.delta)


def rhs(cfg: QGConfig, const: QGConstants, q: torch.Tensor | None,
        psi_g: Ghosted, zeta: torch.Tensor, zeta_g: Ghosted,
        tracers: torch.Tensor | None = None, *, ghost_fn=ghosted,
        ghost_deriv_fn=None):
    """Tendencies (dq, dtracers) (update_qg, msqg/qg.h:609-650). The
    advected vorticity is zeta, with the stretching-Jacobian cascade
    supplying the rest of J(psi, q); every J(., pp) term is pruned when
    there is no large-scale streamfunction. The stochastic variant
    (msqg/qg_stochastic.h:17-111) drops the top layer's self-advection and
    the cascade's J(psi_l, psi_l+1), and damps with -q/tr_stoch. `q` is
    read by ENERGY_CONSERV advection and the stochastic damping only;
    dtracers is None without tracers.

    On a tile of a mesh (the general-mesh step, parallel/step.py),
    `ghost_fn(field, bc)` and `ghost_deriv_fn(field, parent_g)` give a
    field its ghost ring (parallel.halo's sharded forms), as in the JAX
    package's rhs; the padded constants (pp, zetap, topo) come already cut
    to the tile's window with its ring."""
    if ghost_deriv_fn is None:
        def ghost_deriv_fn(f, parent_g):
            return _ghost_deriv(cfg, f, parent_g)
    d = cfg.delta
    nl = cfg.nl
    mj = arakawa_mjac_g
    idh0, idh1 = const.idh0, const.idh1
    have_pg = const.pp_pad is not None
    pp = ghosted_from_padded(const.pp_pad) if have_pg else None
    dq = torch.zeros_like(zeta)
    if nl > 1:
        # advection_pv (msqg/qg.h:287-393); nl == 1 advects nothing
        # (msqg/qg.h:376-379)
        if cfg.energy_conserv:
            # ENERGY_CONSERV split (msqg/qg.h:310-340): the self-advection
            # carries the full PV q under psi's ghost law, so J(psi_l,
            # psi_l+1) drops out of the cascade
            self_jac = mj(psi_g, ghost_fn(q, _bc_psi(cfg)), d)
        else:
            self_jac = mj(psi_g, zeta_g, d)
        if cfg.stochastic:
            self_jac[0] = 0.0
        dq = dq + self_jac + beta_effect_g(psi_g, cfg.beta, d)
        if have_pg:
            dq = dq + mj(pp, zeta_g, d)
        # interface stretch-Jacobian cascade with the pp cross terms
        J = None
        if have_pg:
            J = mj(pp[:-1], psi_g[1:], d) + mj(psi_g[:-1], pp[1:], d)
        if not cfg.energy_conserv and not cfg.stochastic:
            Jself = mj(psi_g[:-1], psi_g[1:], d)
            J = Jself if J is None else J + Jself
        if J is not None:
            sJ = const.strl * J
            for l in range(nl - 1):
                dq[l] += sJ[l] * idh1[l]
            for l in range(1, nl):
                dq[l] += -sJ[l - 1] * idh0[l]
        if const.zetap_pad is not None:
            dq = dq + mj(psi_g, ghosted_from_padded(const.zetap_pad), d)
        if cfg.stochastic:
            dq = dq - q * cfg.itr_stoch

    # dissipation (dissip, msqg/qg.h:406-422), skipped where the
    # coefficient is zero
    tmp = None
    if cfg.iRe != 0.0:
        if nl > 1:
            dq = dq + cfg.iRe * stretch(zeta, const.strl, idh0, idh1)
        tmp = laplacian_g(zeta_g, d)
        dq = dq + cfg.iRe * tmp
    if cfg.iRe4 != 0.0:
        if tmp is None:
            tmp = laplacian_g(zeta_g, d)
        bih = laplacian_g(ghost_deriv_fn(tmp, zeta_g), d)
        if nl > 1:
            bih = bih + stretch(tmp, const.strl, idh0, idh1)
        dq = dq + cfg.iRe4 * bih

    # Ekman friction (msqg/qg.h:428-440) and wind (msqg/qg.h:446-459)
    dh = cfg.dh
    if cfg.Eks != 0.0:
        dq[0] += -cfg.Eks / (cfg.Rom * 2 * dh[0]) * zeta[0]
    if cfg.Ekb != 0.0:
        dq[nl - 1] += -cfg.Ekb / (cfg.Rom * 2 * dh[nl - 1]) * zeta[nl - 1]
    dq[0] += -const.wind

    # 3-D forcing (msqg/qg.h:465-474)
    if const.qforc is not None:
        dq = dq + const.qforc

    # bottom topography (msqg/qg.h:480-488)
    if const.topo_pad is not None:
        dq[nl - 1] += mj(psi_g[nl - 1], ghosted_from_padded(const.topo_pad),
                         d) / (const.Ro * dh[nl - 1])

    dtr = None if tracers is None else tracer_rhs(cfg, const, psi_g, tracers,
                                                  ghost_fn=ghost_fn)
    return dq, dtr


def tracer_rhs(cfg: QGConfig, const: QGConstants, psi_g: Ghosted,
               tracers: torch.Tensor, *, ghost_fn=ghosted) -> torch.Tensor:
    """Passive-tracer tendencies (ptr_rhs, msqg/qg.h:573-588) for the
    (nl, nptr, N, N) tracers: Arakawa advection by psi, diffusion /Pe and
    relaxation, with Neumann walls (wrapped in the periodic run)."""
    d = cfg.delta
    tr_g = ghost_fn(tracers, BC.PERIODIC if cfg.sbc == -1 else BC.NEUMANN)
    coef = dict(dtype=tracers.dtype, device=tracers.device)
    iPe = torch.tensor(cfg.iPe[:cfg.nptr], **coef).reshape(1, -1, 1, 1)
    ir = torch.tensor(cfg.ptr_ir[:cfg.nptr], **coef).reshape(1, -1, 1, 1)
    dtr = arakawa_mjac_g(Ghosted(psi_g.p[:, None]), tr_g, d) \
        + iPe * laplacian_g(tr_g, d)
    if const.ptr_relax is not None:
        return dtr + ir * (const.ptr_relax - tracers)
    return dtr + ir * (-tracers)


def cfl_dtmax(cfg: QGConfig, const: QGConstants, psi_g: Ghosted, dtmax0,
              prev, reduce_fn=None):
    """CFL controller chain from psi (the per-layer face-speed maxima in one
    pass, then the scalar smoothing recurrence); the pp part comes from
    const.umax_pp, the whole domain's. On a tile `reduce_fn` takes psi's
    maxima to the whole domain's (parallel.halo.pmax)."""
    return cfl_from_umax(cfg, max_face_speed_layers(psi_g, cfg.delta),
                         const.umax_pp, dtmax0, prev, reduce_fn=reduce_fn)


def cfl_from_umax(cfg: QGConfig, umax_psi: torch.Tensor,
                  umax_pp: torch.Tensor | None, dtmax0: float,
                  prev: torch.Tensor, reduce_fn=None):
    """The scalar tail of the CFL chain (Basilisk timestep() called per
    layer for psi then pp, sharing the `previous` smoothing state,
    msqg/qg.h:383-391), given the (nl,) per-layer face-speed maxima.
    Without a pp its iterations are exact no-ops and are skipped. 0-d
    tensors throughout. `reduce_fn` takes the maxima of one shard to the
    whole domain's (the rows step's parallel.halo.pmax)."""
    if reduce_fn is not None:
        umax_psi = reduce_fn(umax_psi)
    d = cfg.delta
    dtype = umax_psi.dtype
    big = torch.finfo(dtype).max / 4
    dtm = torch.full((), dtmax0, dtype=dtype, device=umax_psi.device)
    for l in range(cfg.nl):
        umaxes = (umax_psi[l],) if umax_pp is None \
            else (umax_psi[l], umax_pp[l])
        for umax in umaxes:
            dt_cfl = torch.where(umax > 0, cfg.CFL * d / umax, big)
            dtm = torch.minimum(dtm, dt_cfl)
            dtm = torch.where(dtm > prev, (prev + 0.1 * dtm) / 1.1, dtm)
            prev = dtm
    return dtm, prev


def time_filter(q, q_mean, dt, tau_f: float = 20.0):
    """Exponential running mean of the PV (time_filter, msqg/qg.h:491-507;
    tau_f = 20 there, and its subtraction line is commented out, so this
    only keeps the mean): q_mean <- (1 - dt/tau_f) q_mean + (dt/tau_f) q."""
    alpha = dt / tau_f
    return (1.0 - alpha) * q_mean + alpha * q


def dtnext(t, tnext, dt):
    """Basilisk event scheduling: shrink dt so an integer number of steps
    lands exactly on the next event time (events.h dtnext, TEPS=1e-9)."""
    dd = tnext - t
    n = torch.floor(dd / dt)
    dt1 = dd / torch.clamp(n, min=1)
    dt1 = torch.where(dt1 > dt * (1.0 + 1e-9), dd / (n + 1), dt1)
    return torch.where(n == 0, dd, torch.minimum(dt, dt1))


def kinetic_energy(cfg: QGConfig, psi: torch.Tensor, ghost_fn=ghosted,
                   reduce_fn=None) -> torch.Tensor:
    """Surface-layer KE as logged every step: -sum 0.5*psi*lap(psi)*Delta^2
    (msqg/qg.c:101-109). On a shard of rows, `ghost_fn` gives it its ghost
    ring and `reduce_fn` sums the shards' partial sums (the rows step's
    parallel.halo.ghosted_sharded and psum)."""
    p0 = psi[0]
    lap = laplacian_g(ghost_fn(p0, _bc_psi(cfg)), cfg.delta)
    part = torch.sum(0.5 * p0 * lap)
    if reduce_fn is not None:
        part = reduce_fn(part)
    return -part * cfg.delta ** 2


def update(cfg: QGConfig, const: QGConstants, q: torch.Tensor,
           psi_guess: torch.Tensor | None, tracers: torch.Tensor | None,
           prev, dtmax0: float):
    """One RHS evaluation: PV inversion + fused tendency and CFL maxima +
    the fused tracer tendency + the CFL tail; returns (dq, dtr, psi, prev,
    dtm, MGStats). Routes on q's device (fused_rhs.rhs_fused,
    fused_tracer.tracer_fused, the multigrid's fused_mg kernels), and on
    const.rhs_kernel: a strl that varies in x runs the tendency's plain
    version as torch ops, on the card too."""
    psi, st = invert_q(cfg, const, psi_guess, q)
    need_q = cfg.energy_conserv or cfg.stochastic
    rhs_fn = fused_rhs.rhs_fused if const.rhs_kernel \
        else fused_rhs.rhs_fused_reference
    dq, umax = rhs_fn(cfg, const, psi, q if need_q else None)
    dtr = None
    if tracers is not None:
        dtr = fused_tracer.tracer_fused(cfg, const, psi, tracers)
    dtm, prev = cfl_from_umax(cfg, umax, const.umax_pp, dtmax0, prev)
    return dq, dtr, psi, prev, dtm, st


def draw_noise(cfg: QGConfig, const: QGConstants, q: torch.Tensor,
               generator: torch.Generator) -> torch.Tensor:
    """One step's stochastic forcing, amp_stoch * sigma * xi with xi
    standard normal from `generator` (on q's device) and sigma = s_stoch,
    else 1 (qg_stochastic.h:128-149). A different stream from the JAX
    package's jax.random draw: the two agree in distribution only."""
    g, d = generator.device, q.device
    if g.type != d.type or (None not in (g.index, d.index)
                            and g.index != d.index):
        raise ValueError(f"the noise generator is on {g}, the state on {d}")
    xi = torch.randn(q.shape, generator=generator, device=q.device,
                     dtype=q.dtype)
    sigma = 1.0 if const.s_stoch is None else const.s_stoch
    return cfg.amp_stoch * sigma * xi


def make_step(cfg: QGConfig, generator: torch.Generator | None = None):
    """step(state, const, tnext) -> (state, StepDiag): one predictor-
    corrector step (predictor-corrector.h semantics): dt from the
    CFL-limited first update clamped by dtnext, a half-step Euler predictor,
    a corrector RHS at the midpoint, and the full step; the tracers advance
    with q. The first inversion starts from the last psi, or from
    2 psi - psi_old where the state carries psi_old; the second from the
    first's psi. StepDiag reports the first inversion's cycles and
    residual. The filter mean (qof, nbar) passes through unchanged: only
    the filter event updates it.

    With cfg.stochastic the step adds the Euler-Maruyama kick: one draw of
    `draw_noise` a step from `generator` (required, on the state's
    device), shared by the predictor (x sqrt(dt)/2) and the corrector
    (x sqrt(dt)) (qg_stochastic.h:128-149)."""
    DT = cfg.dt_clamped()
    if cfg.stochastic and generator is None:
        raise ValueError("a stochastic step needs a torch.Generator on the "
                         "state's device")

    def step(state: QGState, const: QGConstants, tnext):
        q0, tr0 = state.q, state.tracers
        noise = draw_noise(cfg, const, q0, generator) if cfg.stochastic \
            else None
        guess = state.psi
        if state.psi_old is not None:
            guess = 2.0 * state.psi - state.psi_old
        dq, dtr, psi1, prev, dtm, st1 = update(cfg, const, q0, guess, tr0,
                                               state.dt_prev, DT)
        dt = dtnext(state.t, tnext, dtm)
        q1 = q0 + dq * (0.5 * dt)
        if noise is not None:
            q1 = q1 + noise * torch.sqrt(dt) * 0.5
        tr1 = None if tr0 is None else tr0 + dtr * (0.5 * dt)
        dq, dtr, psi2, prev, _, _ = update(cfg, const, q1, psi1, tr1, prev,
                                           DT)
        q_new = q0 + dq * (1.0 * dt)
        if noise is not None:
            q_new = q_new + noise * torch.sqrt(dt)
        tr_new = None if tr0 is None else tr0 + dtr * (1.0 * dt)
        new = QGState(q=q_new, psi=psi2, t=state.t + dt, dt_prev=prev,
                      i=state.i + 1, tracers=tr_new,
                      psi_old=None if state.psi_old is None else state.psi,
                      qof=state.qof, nbar=state.nbar)
        return new, StepDiag(dt=dt, ke=kinetic_energy(cfg, psi2),
                             mg_iters=st1.iters, mg_res=st1.resa)

    return step
