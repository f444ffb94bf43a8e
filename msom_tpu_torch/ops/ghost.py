"""Ghosted stencil views (the port of `msom_tpu.ops.ghost`).

The JAX package keeps a field at its aligned (N, N) shape and carries its
ghosts as edge vectors, because a padded (N+2, N+2) array breaks the TPU's
(8, 128) tiling. PyTorch has no such constraint, so here a `Ghosted` holds
the padded array itself (the JAX `Ghosted.padded()`) and a neighbour view
is a strided slice of it.
"""

from __future__ import annotations

import dataclasses

import torch

from msom_tpu_torch.ops.bc import BC, pad, pad_zeta_slip


@dataclasses.dataclass(frozen=True)
class Ghosted:
    """An (..., N, N) field with its ghost ring, stored padded."""
    p: torch.Tensor   # (..., N+2, N+2)

    @property
    def a(self) -> torch.Tensor:
        return self.p[..., 1:-1, 1:-1]

    def __getitem__(self, idx):
        """Slice leading (layer) axes, keeping the ghost ring."""
        return Ghosted(self.p[idx])

    def shift(self, dj: int, di: int) -> torch.Tensor:
        """out[j, i] = extended[j + dj, i + di], |dj|, |di| <= 1."""
        ny, nx = self.p.shape[-2] - 2, self.p.shape[-1] - 2
        return self.p[..., 1 + dj:1 + dj + ny, 1 + di:1 + di + nx]


def ghosted(a: torch.Tensor, bc: BC) -> Ghosted:
    """Standard BCs (Dirichlet half-cell / Neumann / periodic), the values of
    ops.bc.pad."""
    return Ghosted(pad(a, bc))


def ghosted_from_padded(pp: torch.Tensor) -> Ghosted:
    """A Ghosted view of an explicitly padded (..., N+2, N+2) array (the
    constant fields whose ghosts are fixed at setup: pp, zetap, topo)."""
    return Ghosted(pp)


def ghosted_slip(zeta: torch.Tensor, psi: Ghosted, sbc: float,
                 delta: float) -> Ghosted:
    """Partial-slip ghosts for a Laplacian-derived field: edge ghosts
    c*(psi_in - psi_ghost) with c = sbc/((0.5*sbc+1)*Delta^2), corner
    ghosts keep the Dirichlet fill (+interior corner); msqg/qg.h:185-198.
    sbc <= 0 is the plain Dirichlet rule."""
    return Ghosted(pad_zeta_slip(zeta, psi.p, sbc, delta))


# ---------------------------------------------------------------------------
# stencil operators on Ghosted fields
# ---------------------------------------------------------------------------

def laplacian_g(g: Ghosted, delta: float) -> torch.Tensor:
    return (g.shift(0, 1) + g.shift(0, -1) + g.shift(1, 0) + g.shift(-1, 0)
            - 4.0 * g.a) / (delta * delta)


def neighbor_sum(g: Ghosted) -> torch.Tensor:
    return g.shift(0, 1) + g.shift(0, -1) + g.shift(1, 0) + g.shift(-1, 0)


def arakawa_mjac_g(p: Ghosted, q: Ghosted, delta: float) -> torch.Tensor:
    """-J(p, q), 12-point Arakawa (msqg macro, msqg/qg.h:252)."""
    pE, pW = p.shift(0, 1), p.shift(0, -1)
    pN, pS = p.shift(1, 0), p.shift(-1, 0)
    pNE, pNW = p.shift(1, 1), p.shift(1, -1)
    pSE, pSW = p.shift(-1, 1), p.shift(-1, -1)
    qE, qW = q.shift(0, 1), q.shift(0, -1)
    qN, qS = q.shift(1, 0), q.shift(-1, 0)
    qNE, qNW = q.shift(1, 1), q.shift(1, -1)
    qSE, qSW = q.shift(-1, 1), q.shift(-1, -1)
    j = ((qE - qW) * (pN - pS)
         + (qS - qN) * (pE - pW)
         + qE * (pNE - pSE)
         - qW * (pNW - pSW)
         - qN * (pNE - pNW)
         + qS * (pSE - pSW)
         + pN * (qNE - qNW)
         - pS * (qSE - qSW)
         - pE * (qNE - qSE)
         + pW * (qNW - qSW))
    return j / (12.0 * delta * delta)


def beta_effect_g(p: Ghosted, beta: float, delta: float) -> torch.Tensor:
    return beta * (p.shift(0, -1) - p.shift(0, 1)) / (2.0 * delta)


def max_face_speed_layers(p: Ghosted, delta: float) -> torch.Tensor:
    """Per-layer max over faces of |u| for the CFL controller. The face
    velocity is the mean of the two adjacent cells' centred derivatives,
    the wall faces included through the ghost ring (corners too). Reduces
    the trailing (y, x) axes only, so (nl, N, N) gives the (nl,) maxima."""
    P = p.p
    # -dpsi/dy at every column of the padded array (ghost columns included),
    # +dpsi/dx at every row, each on the interior of the other axis
    uc = -(P[..., 2:, :] - P[..., :-2, :]) / (2.0 * delta)   # (.., N, N+2)
    vc = (P[..., :, 2:] - P[..., :, :-2]) / (2.0 * delta)    # (.., N+2, N)
    fx = torch.abs(0.5 * (uc[..., :, 1:] + uc[..., :, :-1]))  # N+1 x-faces
    fy = torch.abs(0.5 * (vc[..., 1:, :] + vc[..., :-1, :]))  # N+1 y-faces
    return torch.maximum(fx.amax(dim=(-2, -1)), fy.amax(dim=(-2, -1)))
