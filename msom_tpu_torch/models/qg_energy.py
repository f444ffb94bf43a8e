"""Term-by-term energy budget of the msqg model (the port of
`msom_tpu.models.qg_energy`).

The reference's msqg/qg_energy.h: every PV-equation term times the weight
w = -psi (1 - ediag) + ediag and dt, summed into one field a term between
outputs:
  de_j1  the self-advection J(psi, q) part
  de_j2  the large-scale coupling J(psi_pg, q) part
  de_j3  beta and J(psi, q_pg)
  de_vd  harmonic and biharmonic dissipation
  de_bf  surface and bottom Ekman friction
  de_ft  the wavelet filter's energy flux (summed at filter events)
The cross term jc = J(psi, psi_pg) cancels between j2 and j3 as in the
reference's split (qg_energy.h:19-26, 70-71). Torch ops on either device,
on the port's ghost views; strl is the (nl-1, N, 1) y-profile or, with a
frpg that varies in x, the (nl-1, N, N) field: both broadcast.
"""

from __future__ import annotations

import dataclasses

import torch

from msom_tpu_torch.models.qg import (QGConstants, _bc_psi, _ghost_deriv,
                                      comp_q, invert_q)
from msom_tpu_torch.ops.ghost import (arakawa_mjac_g, beta_effect_g,
                                      ghosted, ghosted_from_padded,
                                      laplacian_g)
from msom_tpu_torch.ops.stretch import stretch
from msom_tpu_torch.ops.wavelet import filter_field
from msom_tpu_torch.params import QGConfig


@dataclasses.dataclass
class EnergyAccum:
    de_bf: torch.Tensor
    de_vd: torch.Tensor
    de_j1: torch.Tensor
    de_j2: torch.Tensor
    de_j3: torch.Tensor
    de_ft: torch.Tensor
    po_mft: torch.Tensor    # running mean of psi between filter events
    nme_ft: torch.Tensor    # 0-d int32: steps in po_mft


FIELDS = ("de_bf", "de_vd", "de_j1", "de_j2", "de_j3", "de_ft")


def init_energy(cfg: QGConfig, device="cuda") -> EnergyAccum:
    z = torch.zeros((cfg.nl, cfg.N, cfg.N), dtype=getattr(torch, cfg.dtype),
                    device=device)
    return EnergyAccum(**{name: z for name in FIELDS}, po_mft=z,
                       nme_ft=torch.zeros((), dtype=torch.int32,
                                          device=device))


def _weight(psi, ediag):
    return -psi * (1.0 - ediag) + ediag


def _layer_coef(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=like.dtype,
                        device=like.device).reshape(-1, 1, 1)


def advection_de(cfg: QGConfig, const: QGConstants, psi, psi_g, zeta_g,
                 dt, ediag):
    """(dj1, dj2, dj3) increments (advection_de, msqg/qg_energy.h:27-154),
    over all layers at once with the reference's swap of the upward terms:
    ju1 = -jd1, ju2 = -jd3, ju3 = -jd2 of the layer above."""
    d = cfg.delta
    nl = cfg.nl
    mj = arakawa_mjac_g
    # without a large-scale streamfunction every J(., pp) term is zero
    have_pg = const.pp_pad is not None
    pp = ghosted_from_padded(const.pp_pad) if have_pg else None
    w = _weight(psi, ediag) * dt
    dj1 = mj(psi_g, zeta_g, d) * w
    dj2 = mj(pp, zeta_g, d) * w if have_pg else torch.zeros_like(dj1)
    dj3 = beta_effect_g(psi_g, cfg.beta, d) * w
    if cfg.flsrv == 1 and const.zetap_pad is not None:
        dj3 = dj3 + mj(psi_g, ghosted_from_padded(const.zetap_pad), d) * w
    if nl > 1:
        idh0 = _layer_coef(const.idh0, psi)
        idh1 = _layer_coef(const.idh1, psi)
        s = const.strl
        jd1 = mj(psi_g[:-1], psi_g[1:], d)         # (nl-1, N, N) interfaces
        # downward terms at layers l < nl-1, upward ones at l > 0
        dj1[:-1] += s * jd1 * idh1[:-1] * w[:-1]
        dj1[1:] += -s * jd1 * idh0[1:] * w[1:]
        if have_pg:
            jd2 = mj(pp[:-1], psi_g[1:], d)
            jd3 = mj(psi_g[:-1], pp[1:], d)
            jc = mj(psi_g, pp, d)                   # (nl, N, N) a layer
            dj2[:-1] += s * (jd2 + jc[:-1]) * idh1[:-1] * w[:-1]
            dj3[:-1] += s * (jd3 - jc[:-1]) * idh1[:-1] * w[:-1]
            dj2[1:] += s * (-jd3 + jc[1:]) * idh0[1:] * w[1:]
            dj3[1:] += s * (-jd2 - jc[1:]) * idh0[1:] * w[1:]
    return dj1, dj2, dj3


def dissip_de(cfg: QGConfig, const: QGConstants, psi, zeta, zeta_g, dt,
              ediag):
    """de_vd increment (dissip_de, msqg/qg_energy.h:157-187)."""
    d = cfg.delta
    w = _weight(psi, ediag) * dt
    tmp = laplacian_g(zeta_g, d)
    out = cfg.iRe * tmp * w
    if cfg.nl > 1:
        out = out + cfg.iRe * stretch(zeta, const.strl, const.idh0,
                                      const.idh1) * w
    bih = laplacian_g(_ghost_deriv(cfg, tmp, zeta_g), d)
    if cfg.nl > 1:
        bih = bih + stretch(tmp, const.strl, const.idh0, const.idh1)
    return out + cfg.iRe4 * bih * w


def ekman_de(cfg: QGConfig, psi, zeta, dt, ediag):
    """de_bf increment (msqg/qg_energy.h:190-204)."""
    w = _weight(psi, ediag) * dt
    out = torch.zeros_like(psi)
    nl = cfg.nl
    out[0] += -cfg.Eks / (cfg.Rom * 2 * cfg.dh[0]) * zeta[0] * w[0]
    out[nl - 1] += (-cfg.Ekb / (cfg.Rom * 2 * cfg.dh[nl - 1])
                    * zeta[nl - 1] * w[nl - 1])
    return out


def energy_tend(cfg: QGConfig, const: QGConstants, acc: EnergyAccum, psi,
                dt) -> EnergyAccum:
    """One step's accumulation (energy_tend and the comp_diag event,
    msqg/qg_energy.h:228-242, 286-288); `dt` the step's (0-d) dt."""
    ediag = float(max(cfg.ediag, 0))
    psi_g = ghosted(psi, _bc_psi(cfg))
    zeta = laplacian_g(psi_g, cfg.delta)
    zeta_g = _ghost_deriv(cfg, zeta, psi_g)
    dj1, dj2, dj3 = advection_de(cfg, const, psi, psi_g, zeta_g, dt, ediag)
    dvd = dissip_de(cfg, const, psi, zeta, zeta_g, dt, ediag)
    dbf = ekman_de(cfg, psi, zeta, dt, ediag)
    po_mft = (acc.po_mft * acc.nme_ft + psi) / (acc.nme_ft + 1)
    return dataclasses.replace(
        acc, de_j1=acc.de_j1 + dj1, de_j2=acc.de_j2 + dj2,
        de_j3=acc.de_j3 + dj3, de_vd=acc.de_vd + dvd, de_bf=acc.de_bf + dbf,
        po_mft=po_mft, nme_ft=acc.nme_ft + 1)


def filter_de(cfg: QGConfig, const: QGConstants, acc: EnergyAccum, q,
              psi) -> EnergyAccum:
    """The filter event's energy flux (filter_de, msqg/qg_energy.h:207-226):
    the filter evaluated WITHOUT advancing the state (the reference's
    dtflt < 0 call restores q) and de_ft += (q_pre - q_post)/(-dtflt) *
    dtflt * w(po_mft); the psi mean restarts."""
    ediag = float(max(cfg.ediag, 0))
    psi_inv, _ = invert_q(cfg, const, psi, q)
    psi_f = filter_field(psi_inv, const.sig_lev, _bc_psi(cfg))
    q_post = comp_q(cfg, const, psi_f)
    tmp2 = (q - q_post) / (-cfg.dtflt)
    de_ft = acc.de_ft + tmp2 * cfg.dtflt * _weight(acc.po_mft, ediag)
    return dataclasses.replace(acc, de_ft=de_ft,
                               po_mft=torch.zeros_like(acc.po_mft),
                               nme_ft=torch.zeros_like(acc.nme_ft))


def reset_window(acc: EnergyAccum) -> EnergyAccum:
    """Zero the window's sums after an output flush (msqg/qg.c:159-166)."""
    z = torch.zeros_like(acc.de_bf)
    return dataclasses.replace(acc, **{name: z for name in FIELDS})
