"""Typed msqg and mspg run configurations and the params.in parsers.

The port's own copy of `msom_tpu.params.QGConfig`, `PGConfig`, `_parse_kv`,
`load_qg_config` and `load_pg_config`: the same fields, defaults, derived
properties and validation, so that a deck (e.g.
`msom_tpu/configs/double_gyre_small.in`) parses to the same configuration
in both packages. Derived values (inverse Reynolds numbers, the viscous-CFL
clamp on DT) mirror the reference's msqg/qg.h:739-754.

Two fields are JAX-runtime knobs that the port reads differently:
`use_pallas` chooses no kernel (the port's fused RHS runs on every CUDA
tensor and its plain version on every CPU tensor) and only routes the
sharded run as the JAX package's does (use_pallas=False takes "gspmd",
parallel/step.py rows_refusal), and `transform` keeps its meaning for the
spectral solve.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


def _parse_kv(path_or_text: str) -> dict:
    """Parse the reference params.in grammar into {key: float|int|tuple}."""
    if "=" in path_or_text or "\n" in path_or_text:
        text = path_or_text  # inline deck
    else:
        with open(path_or_text) as f:  # a path: missing file must error
            text = f.read()
    out = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].replace(" ", "").replace("\t", "")
        if "=" not in line:
            continue
        key, val = line.split("=", 1)
        if not key:
            continue
        if val.startswith("["):
            out[key] = tuple(float(v) for v in val.strip("[]").split(",") if v)
        else:
            try:
                out[key] = int(val)
            except ValueError:
                try:
                    out[key] = float(val)
                except ValueError:
                    out[key] = val
    return out


@dataclasses.dataclass(frozen=True)
class QGConfig:
    """msqg configuration (defaults match the reference's msqg/qg.h:63-106
    and Basilisk globals DT=1e10, CFL=0.5)."""

    N: int = 64
    nl: int = 1
    L0: float = 1.0
    # physics
    Rom: float = 0.0         # mean Rossby number (must be > 0)
    Ekb: float = 0.0         # bottom Ekman number
    Eks: float = 0.0         # surface Ekman number
    tau0: float = 0.0        # wind stress curl amplitude
    Re: float = 0.0          # Reynolds number (harmonic)
    Re4: float = 0.0         # biharmonic Reynolds number
    beta: float = 0.5
    sbc: float = 0.0         # -1 periodic, 0 free-slip, >0 partial slip
    Fr: Tuple[float, ...] = ()
    dh: Tuple[float, ...] = (1.0,)
    upg: Tuple[float, ...] = ()   # background zonal flow per layer
    vpg: Tuple[float, ...] = ()
    varRo: int = 0
    flsrv: int = 0           # advect large-scale relative vorticity
    energy_conserv: bool = False  # ENERGY_CONSERV advection split
    # filter
    afilt: float = 10.0
    Lfmax: float = 1e10
    dtflt: float = -1.0
    # tracers
    nptr: int = 0
    Pe: Tuple[float, ...] = ()
    ptr_r: Tuple[float, ...] = ()
    # energy diagnostics
    ediag: int = -1
    # stochastic
    tr_stoch: float = 0.0
    amp_stoch: float = 1.0
    stochastic: bool = False
    # timestepping
    DT: float = 1e10
    tend: float = 1.0
    dtout: float = 1.0
    CFL: float = 0.5
    # numerics
    tol: float = 1e-3        # PV-inversion tolerance (msqg/qg.h:159)
    mode_pv_invert: bool = False  # modal inversion path (msqg/qg.h:4,109-157)
    solver: str = "mg"       # "mg" (multigrid) or "spectral" (direct solve)
    use_pallas: bool = True  # JAX-runtime knob; routes the sharded run
    transform: str = "auto"  # spectral basis: "auto" | "fft" | "matmul" |
    #                          "factored" (see solvers/spectral.py)
    mg_extrap: bool = True   # mg warm-start extrapolation (mg solver only)
    dtype: str = "float32"

    # ----- derived (read-only properties) -----
    @property
    def iRe(self) -> float:
        return 0.0 if self.Re == 0 else 1.0 / self.Re

    @property
    def iRe4(self) -> float:
        # NOTE the minus sign: msqg/qg.h:740
        return 0.0 if self.Re4 == 0 else -1.0 / self.Re4

    @property
    def itr_stoch(self) -> float:
        return 0.0 if self.tr_stoch == 0 else 1.0 / self.tr_stoch

    @property
    def iPe(self) -> Tuple[float, ...]:
        return tuple((0.0 if p == 0 else 1.0 / p) for p in self.Pe)

    @property
    def ptr_ir(self) -> Tuple[float, ...]:
        return tuple((0.0 if r == 0 else 1.0 / r) for r in self.ptr_r)

    @property
    def delta(self) -> float:
        return self.L0 / self.N

    def dt_clamped(self) -> float:
        """Viscous-CFL clamps applied at parse time (msqg/qg.h:745-746)."""
        DT = self.DT
        if self.Re != 0:
            DT = 0.5 * min(DT, (self.L0 / self.N) ** 2 * self.Re / 4.0)
        if self.Re4 != 0:
            DT = 0.5 * min(DT, (self.L0 / self.N) ** 4 * self.Re4 / 32.0)
        return DT

    def validate(self):
        if self.solver not in ("mg", "spectral"):
            raise ValueError(f"solver={self.solver!r}: must be 'mg' or "
                             "'spectral'")
        if self.transform not in ("auto", "fft", "matmul", "factored"):
            raise ValueError(f"transform={self.transform!r}: must be "
                             "'auto', 'fft', 'matmul' or 'factored'")
        if self.Rom <= 0:
            raise ValueError("Rom <= 0: aborting (msqg/qg.h:1009-1012)")
        if len(self.dh) < self.nl or any(d == 0 for d in self.dh[:self.nl]):
            raise ValueError("thickness = 0: check dh in params.in "
                             "(msqg/qg.h:990-996)")
        if self.nl > 1 and len(self.Fr) < self.nl - 1:
            raise ValueError(f"need {self.nl - 1} Froude numbers, got {self.Fr}")
        if self.energy_conserv and self.stochastic:
            # the reference's stochastic module replaces advection_pv
            # wholesale (#ifndef _STOCHASTIC, qg_stochastic.h:17)
            raise ValueError("energy_conserv and stochastic are mutually "
                             "exclusive (qg_stochastic.h replaces "
                             "advection_pv)")
        return self


_QG_KEYS = {f.name for f in dataclasses.fields(QGConfig)}


def load_qg_config(path_or_text: str, **overrides) -> QGConfig:
    """Read a reference msqg params.in (grammar of msqg/qg.h:689-761) into a
    QGConfig."""
    kv = _parse_kv(path_or_text)
    kw = {key: val for key, val in kv.items() if key in _QG_KEYS}
    kw.update(overrides)
    return QGConfig(**kw).validate()


@dataclasses.dataclass(frozen=True)
class PGConfig:
    """mspg configuration (defaults match the reference's mspg/pg.h:16-57;
    the parser's keys are pg.c:60-76's: the reference's own deck keys `kd`,
    `a` and `nu` are not read by its parser and are ignored here too, nu
    keeping its compiled-in default 3e-4)."""

    N: int = 64
    nl: int = 1
    L0: float = 1.0
    ys: float = 0.0          # southern latitude (origin shift, pg.c:97)
    r: float = 0.1           # linear friction
    kv: float = 0.0          # vertical diffusivity coefficient
    kh: float = 0.0          # horizontal diffusivity coefficient
    nu: float = 3e-4         # momentum viscosity (global, not parsed)
    tau_s: float = 1e-2      # surface buoyancy relaxation time
    tau0: float = 0.12       # wind amplitude
    k_gm: float = 0.0        # Gent-McWilliams coefficient
    N2min: float = 1e-10
    cmin: float = 2.0
    omega: float = 0.3       # pseudo-SOR relaxation factor
    DT: float = 1e10
    CFL: float = 0.5
    tend: float = 1.0
    dtout: float = 1.0
    tol: float = 1e-3
    dtype: str = "float32"

    @property
    def delta(self) -> float:
        return self.L0 / self.N


_PG_KEYS = {f.name for f in dataclasses.fields(PGConfig)} - {"nu"}


def load_pg_config(path_or_text: str, **overrides) -> PGConfig:
    """Read a reference mspg params.in (grammar of mspg/pg.c:60-76) into a
    PGConfig."""
    kv = _parse_kv(path_or_text)
    kw = {key: val for key, val in kv.items() if key in _PG_KEYS}
    kw.update(overrides)
    return PGConfig(**kw)
