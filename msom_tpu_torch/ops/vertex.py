"""Vertex-grid (nodal) operators for the qg-node family (the port of
`msom_tpu.ops.vertex`).

Fields live on the (N+1) x (N+1) cell corners; the boundary nodes lie on
the walls and carry boundary values (psi = psi_bc, vorticity-like fields
from the partial-slip relation, qg-node/qg.h:197-226), and an interior mask
(1 inside, 0 on the boundary nodes, qg-node/qg.h:422-431) multiplies every
tendency. Because the boundary nodes are in the array, a full (N+1)^2 array
is its own padded array: the stencils of ops.stencil apply to it as they
are, and their interior is the (N-1)^2 interior nodes.

The hierarchy transfers (level l has 2^l + 1 nodes a side, my_vertex.h)
are written as strided slices and strided writes: the JAX package's
pad/reshape decimation and stack/reshape interleave work around faults of
the TPU compiler, which torch does not have, and a transfer here costs a
handful of launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def interior(a: torch.Tensor) -> torch.Tensor:
    """(N-1)^2 interior-node view of a vertex array."""
    return a[..., 1:-1, 1:-1]


def set_ring(a: torch.Tensor, left, right, bottom, top,
             corners=0.0) -> torch.Tensor:
    """A copy of `a` with its boundary ring overwritten. left/right/bottom/
    top are scalars or (..., N-1) tensors (the non-corner boundary
    nodes)."""
    a = a.clone()
    a[..., 1:-1, 0] = left
    a[..., 1:-1, -1] = right
    a[..., 0, 1:-1] = bottom
    a[..., -1, 1:-1] = top
    for j in (0, -1):
        for i in (0, -1):
            a[..., j, i] = corners
    return a


def zero_ring_(a: torch.Tensor) -> torch.Tensor:
    """Zero the boundary ring of `a` in place (set_ring(a, 0, 0, 0, 0) on
    an array the caller owns); returns `a`."""
    a[..., 0, :] = 0.0
    a[..., -1, :] = 0.0
    a[..., :, 0] = 0.0
    a[..., :, -1] = 0.0
    return a


def bc_psi(psi: torch.Tensor, psi_bc=0.0) -> torch.Tensor:
    """psi = psi_bc on every boundary node (set_bc, qg.h:202-205)."""
    return set_ring(psi, psi_bc, psi_bc, psi_bc, psi_bc, psi_bc)


def bc_deriv(field: torch.Tensor, psi: torch.Tensor, bc_fac: float,
             delta: float, psi_bc=0.0) -> torch.Tensor:
    """Vorticity-like boundary nodes from the partial-slip relation
    (qg.h:211-214, set_bc_ms qg_baroclinic_ms.h:61-69):
    value = 2 bc_fac / Delta^2 * (first_interior(psi) - psi_bc), corners 0.
    bc_fac = 0 is free slip, 1 no slip."""
    c = 2.0 * bc_fac / (delta * delta)
    return set_ring(field,
                    c * (psi[..., 1:-1, 1] - psi_bc),
                    c * (psi[..., 1:-1, -2] - psi_bc),
                    c * (psi[..., 1, 1:-1] - psi_bc),
                    c * (psi[..., -2, 1:-1] - psi_bc),
                    0.0)


def bc_deriv_rel(field: torch.Tensor, parent: torch.Tensor, bc_fac: float,
                 delta: float) -> torch.Tensor:
    """set_bc_ms's rule for a second derived field (the biharmonic
    intermediate, qg_baroclinic_ms.h:67-69): ring value =
    2 bc_fac / Delta^2 * (first_interior(parent) - parent_ring), the
    parent's own ring value subtracted; corners 0."""
    c = 2.0 * bc_fac / (delta * delta)
    return set_ring(field,
                    c * (parent[..., 1:-1, 1] - parent[..., 1:-1, 0]),
                    c * (parent[..., 1:-1, -2] - parent[..., 1:-1, -1]),
                    c * (parent[..., 1, 1:-1] - parent[..., 0, 1:-1]),
                    c * (parent[..., -2, 1:-1] - parent[..., -1, 1:-1]),
                    0.0)


def vlap(a: torch.Tensor, delta: float) -> torch.Tensor:
    """5-point vertex Laplacian on the interior nodes, zero on the ring."""
    lap = (a[..., 1:-1, 2:] + a[..., 1:-1, :-2] + a[..., 2:, 1:-1]
           + a[..., :-2, 1:-1] - 4 * a[..., 1:-1, 1:-1]) / (delta * delta)
    return F.pad(lap, (1, 1, 1, 1))


def default_mask(N: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """1 at the interior nodes, 0 on the boundary ring (qg.h:422-431)."""
    m = torch.zeros((N + 1, N + 1), dtype=dtype, device=device)
    m[1:-1, 1:-1] = 1.0
    return m


# ---------------------------------------------------------------------------
# vertex hierarchy transfers (my_vertex.h)
# ---------------------------------------------------------------------------

def vrestrict_inject(f: torch.Tensor) -> torch.Tensor:
    """restriction_vert (my_vertex.h:49-51): coarse node = the co-located
    fine node."""
    return f[..., ::2, ::2].contiguous()


def _zero_padded(f: torch.Tensor) -> torch.Tensor:
    """f with a ring of zeros around its last two axes."""
    return F.pad(f, (1, 1, 1, 1))


def vrestrict_weighted(f: torch.Tensor) -> torch.Tensor:
    """restriction_coarsen_vert (my_vertex.h:55-62): coarse =
    (2C + E + W + N + S) / 6 of the co-located fine node, neighbours
    beyond the edge zero (residual BCs are zero, nodal-poisson.h:46-50);
    evaluated at the co-located nodes only."""
    fp = _zero_padded(f)
    C = fp[..., 1:-1:2, 1:-1:2]
    E = fp[..., 1:-1:2, 2::2]
    W = fp[..., 1:-1:2, :-2:2]
    Nn = fp[..., 2::2, 1:-1:2]
    S = fp[..., :-2:2, 1:-1:2]
    return (2 * C + E + W + Nn + S) / 6.0


def vrestrict_weighted16(f: torch.Tensor) -> torch.Tensor:
    """restriction_coarsen_vert2 (my_vertex.h:65-75), used for the mask:
    (4C + 2(E + W + N + S) + corners) / 16, zero beyond the edge."""
    fp = _zero_padded(f)
    C = fp[..., 1:-1:2, 1:-1:2]
    E, W = fp[..., 1:-1:2, 2::2], fp[..., 1:-1:2, :-2:2]
    Nn, S = fp[..., 2::2, 1:-1:2], fp[..., :-2:2, 1:-1:2]
    NE, NW = fp[..., 2::2, 2::2], fp[..., 2::2, :-2:2]
    SE, SW = fp[..., :-2:2, 2::2], fp[..., :-2:2, :-2:2]
    return (4 * C + 2 * (E + W + Nn + S) + NE + NW + SE + SW) / 16.0


def vprolong(c: torch.Tensor) -> torch.Tensor:
    """refine_vert (my_vertex.h:82-105): injection at the co-located nodes,
    the 2-point mean at edge midpoints, the 4-point mean at centres.
    (..., n, n) -> (..., 2n-1, 2n-1), four strided writes into one new
    array."""
    n = c.shape[-1]
    out = c.new_empty(*c.shape[:-2], 2 * n - 1, 2 * n - 1)
    out[..., ::2, ::2] = c
    out[..., ::2, 1::2] = 0.5 * (c[..., :, :-1] + c[..., :, 1:])
    out[..., 1::2, ::2] = 0.5 * (c[..., :-1, :] + c[..., 1:, :])
    out[..., 1::2, 1::2] = 0.25 * (c[..., :-1, :-1] + c[..., :-1, 1:]
                                   + c[..., 1:, :-1] + c[..., 1:, 1:])
    return out
