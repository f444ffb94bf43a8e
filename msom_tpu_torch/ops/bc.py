"""Ghost-cell boundary conditions (the port of `msom_tpu.ops.bc`).

A BC is applied by returning a padded copy: interior (..., ny, nx) ->
(..., ny+2, nx+2). Corners come from sequential application, x (axis -1)
first, then y on the x-padded array, which reproduces Basilisk's
dimension-by-dimension boundary traversal: for Dirichlet the corner ghost
is +interior corner (two sign flips).
"""

from __future__ import annotations

import enum

import torch


class BC(str, enum.Enum):
    DIRICHLET = "dirichlet"  # value 0 half a cell outside: ghost = -interior
    NEUMANN = "neumann"      # zero normal gradient: ghost = interior
    PERIODIC = "periodic"    # wrap


def _pad_axis(a: torch.Tensor, bc: BC, axis: int) -> torch.Tensor:
    lo = a.narrow(axis, 0, 1)
    hi = a.narrow(axis, a.shape[axis] - 1, 1)
    if bc is BC.PERIODIC:
        left, right = hi, lo
    elif bc is BC.DIRICHLET:
        left, right = -lo, -hi
    elif bc is BC.NEUMANN:
        left, right = lo, hi
    else:
        raise ValueError(bc)
    return torch.cat([left, a, right], dim=axis)


def pad(a: torch.Tensor, bc: BC) -> torch.Tensor:
    """Pad the last two axes by one ghost cell each side under `bc`, x
    first, then y."""
    return _pad_axis(_pad_axis(a, bc, -1), bc, -2)


def pad_zeta_slip(zeta: torch.Tensor, psi_pad: torch.Tensor, sbc: float,
                  delta: float) -> torch.Tensor:
    """Ghost pad for a Laplacian-derived field with the partial-slip wall
    law (the sbc > 0 branch of comp_del2, msqg/qg.h:185-198): after the
    Dirichlet fill, the non-corner edge ghosts become
    c * (psi_interior - psi_ghost), c = sbc/((0.5*sbc+1)*Delta^2).
    `psi_pad` is the padded field the Laplacian was taken of. sbc <= 0 gives
    the plain Dirichlet pad (free slip)."""
    zp = pad(zeta, BC.DIRICHLET)
    if sbc <= 0:
        return zp
    c = sbc / ((0.5 * sbc + 1.0) * delta * delta)
    zp[..., 1:-1, 0] = c * (psi_pad[..., 1:-1, 1] - psi_pad[..., 1:-1, 0])
    zp[..., 1:-1, -1] = c * (psi_pad[..., 1:-1, -2] - psi_pad[..., 1:-1, -1])
    zp[..., 0, 1:-1] = c * (psi_pad[..., 1, 1:-1] - psi_pad[..., 0, 1:-1])
    zp[..., -1, 1:-1] = c * (psi_pad[..., -2, 1:-1] - psi_pad[..., -1, 1:-1])
    return zp
