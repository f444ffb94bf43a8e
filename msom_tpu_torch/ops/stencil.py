"""Horizontal stencil operators on padded arrays (the port of
`msom_tpu.ops.stencil`).

Every operator takes padded arrays (..., ny+2, nx+2) made by ops.bc.pad and
returns interior arrays (..., ny, nx). Basilisk's `f[a, b]` (a the x
offset, b the y offset) is `shift(fp, b, a)` here. The Ghosted operators of
ops.ghost compute the same values from the same padded storage; these take
the bare array, as `build_constants` needs for zetap = lap(pp_pad).
"""

from __future__ import annotations

import torch

from msom_tpu_torch.ops.ghost import (Ghosted, arakawa_mjac_g, beta_effect_g,
                                      laplacian_g)


def shift(ap: torch.Tensor, dj: int, di: int) -> torch.Tensor:
    """Interior view of a 1-ghost padded array, offset by (dj, di) in
    (y, x)."""
    return Ghosted(ap).shift(dj, di)


def laplacian(ap: torch.Tensor, delta: float) -> torch.Tensor:
    """5-point Laplacian (laplacian macro, msqg/qg.h:169)."""
    return laplacian_g(Ghosted(ap), delta)


def arakawa_mjac(pp: torch.Tensor, qp: torch.Tensor,
                 delta: float) -> torch.Tensor:
    """-J(p, q), the 12-point Arakawa bracket (msqg/qg.h:252-262)."""
    return arakawa_mjac_g(Ghosted(pp), Ghosted(qp), delta)


def beta_effect(pp: torch.Tensor, beta: float, delta: float) -> torch.Tensor:
    """-beta v = beta (p[-1] - p[1]) / (2 Delta) (msqg/qg.h:269)."""
    return beta_effect_g(Ghosted(pp), beta, delta)


def face_velocities(pp: torch.Tensor, delta: float):
    """Face-centred geostrophic velocities from a padded streamfunction
    (comp_vel, msqg/qg.h:275-283): u = -dpsi/dy on the x-faces and
    v = +dpsi/dx on the y-faces, each the mean over the two adjacent cells.
    Returns (ufx, ufy) of shapes (..., ny, nx+1) and (..., ny+1, nx), the
    wall faces included through the ghosts."""
    ufx = -0.25 * ((pp[..., 2:, 1:] - pp[..., :-2, 1:])
                   + (pp[..., 2:, :-1] - pp[..., :-2, :-1])) / delta
    ufy = 0.25 * ((pp[..., 1:, 2:] - pp[..., 1:, :-2])
                  + (pp[..., :-1, 2:] - pp[..., :-1, :-2])) / delta
    return ufx, ufy
