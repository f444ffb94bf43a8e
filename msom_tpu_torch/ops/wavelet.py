"""Level-hierarchy wavelet transform and the scale-selective filter (the
port of `msom_tpu.ops.wavelet`).

Basilisk's wavelet/inverse_wavelet pair (the masked variant,
qg-node/wavelet_vertex.h:10-46) and the msqg filter event (wavelet_filter,
msqg/qg.h:509-560): the detail at level l is w_l = s_l - P(s_{l-1}), P the
bilinear prolongation under the field's ghost law and s_{l-1} the 4-cell
average of s_l; each level is damped by the sig_lev weights from the local
filter scale (msqg/qg.h:1052-1090) and the field is rebuilt. The pyramid is
a tuple of (..., 2^l, 2^l) tensors, l = 0..log2 N, each level a few torch
ops on the field's device (`solvers/mg.restrict_cell` and
`prolong_bilinear`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from msom_tpu_torch.ops.bc import BC
from msom_tpu_torch.solvers.mg import prolong_bilinear, restrict_cell


def wavelet(s: torch.Tensor, bc: BC, mask_pyramid=None) -> tuple:
    """Forward transform: (w_0, ..., w_depth), w_l of shape (..., 2^l, 2^l);
    w_0 is the root-cell average, w_l the detail at level l. With
    mask_pyramid (qg-node's wavelet_mask) each level is multiplied by its
    mask."""
    depth = int(round(np.log2(s.shape[-1])))
    pyr = [s]
    for _ in range(depth):
        pyr.append(restrict_cell(pyr[-1]))
    pyr.reverse()  # pyr[l] = the field at level l
    w = [pyr[0]]
    for l in range(1, depth + 1):
        w.append(pyr[l] - prolong_bilinear(pyr[l - 1], bc))
    if mask_pyramid is not None:
        w = [wl * ml for wl, ml in zip(w, mask_pyramid)]
    return tuple(w)


def inverse_wavelet(w, bc: BC, mask_pyramid=None) -> torch.Tensor:
    """Rebuild the finest level from the detail pyramid."""
    if mask_pyramid is not None:
        s = w[0] * mask_pyramid[0]
        for l in range(1, len(w)):
            s = (prolong_bilinear(s, bc) + w[l]) * mask_pyramid[l]
        return s
    s = w[0]
    for l in range(1, len(w)):
        s = prolong_bilinear(s, bc) + w[l]
    return s


def sig_lev_pyramid(sig_filt: np.ndarray, L0: float, highpass: bool = True):
    """Per-level filter weights from the cutoff scale sig_filt, an (N, N)
    array at the finest level (msqg/qg.h:1063-1090), in float64 numpy.

    The low-pass weight at level l (cell size Delta_l) is 0 where sig_filt
    > 2 Delta, a linear ramp on (Delta, 2 Delta], else 1, and 1 wherever a
    child has a nonzero weight. Returns the high-pass complement
    (1 - low-pass) unless highpass=False: a tuple of (2^l, 2^l) arrays,
    l = 0..depth."""
    N = sig_filt.shape[-1]
    depth = int(round(np.log2(N)))
    sf = [np.asarray(sig_filt, np.float64)]
    for _ in range(depth):
        s = sf[-1]
        sf.append(0.25 * (s[::2, ::2] + s[1::2, ::2] + s[::2, 1::2]
                          + s[1::2, 1::2]))
    sf.reverse()  # sf[l] at level l
    sig = [None] * (depth + 1)
    for l in range(depth, -1, -1):
        delta = L0 / 2 ** l
        s = sf[l]
        base = np.where(s > 2 * delta, 0.0,
                        np.where(s > delta, 1.0 - (s - delta) / delta, 1.0))
        if l < depth:
            ch = sig[l + 1]
            ref_flag = (ch[::2, ::2] + ch[1::2, ::2] + ch[::2, 1::2]
                        + ch[1::2, 1::2])
            base = np.where(ref_flag > 0, 1.0, base)
        sig[l] = base
    if highpass:
        sig = [1.0 - s for s in sig]
    return tuple(sig)


def filter_field(s: torch.Tensor, sig_pyramid, bc: BC,
                 mask_pyramid=None) -> torch.Tensor:
    """Scale-selective filter of one (layered) field: transform, damp level
    l by sig_pyramid[l] (tensors on s's device), rebuild
    (msqg/qg.h:524-540)."""
    w = wavelet(s, bc, mask_pyramid)
    w = tuple(wl * sl for wl, sl in zip(w, sig_pyramid))
    return inverse_wavelet(w, bc, mask_pyramid)


def wavelet_filter_step(cfg, const, state):
    """The msqg filter event (wavelet_filter, msqg/qg.h:509-560): invert
    the PV, filter psi keeping the small scales, recompute q, and fold
    (q_pre - q_post) / dtflt into the filter-mean PV flux qof, a running
    mean over the events (nbar of them so far)."""
    from msom_tpu_torch.models import qg

    q_pre = state.q
    psi, _ = qg.invert_q(cfg, const, state.psi, state.q)
    psi_f = filter_field(psi, const.sig_lev, qg._bc_psi(cfg))
    q_post = qg.comp_q(cfg, const, psi_f)
    nbar = state.nbar if state.nbar is not None else torch.zeros(
        (), dtype=torch.int32, device=q_pre.device)
    qof = state.qof if state.qof is not None else torch.zeros_like(q_pre)
    qof = (qof * nbar + (q_pre - q_post) / cfg.dtflt) / (nbar + 1)
    return dataclasses.replace(state, q=q_post, psi=psi_f, qof=qof,
                               nbar=nbar + 1)
