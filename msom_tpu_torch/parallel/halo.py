"""Halo exchanges of a rows decomposition (the rows-mesh part of the port
of `msom_tpu.parallel.halo`, over torch.distributed).

Rank r of a world of W holds the rows [r n_loc, (r + 1) n_loc) of every
(..., N, N) field, x whole. Its y-neighbours are ranks r - 1 (the rows
below, "up" in the halo slabs' order) and r + 1, wrapped around when the
domain is periodic. The exchanges are point-to-point (batch_isend_irecv):
every rank sends its first rows to r - 1 and its last rows to r + 1. At
world size 1 nothing is sent (a send to the same rank is no supported NCCL
pattern): the slabs are the shard's own rows (periodic) or zeros (walls).
The reductions (`pmax`, `psum`) go through the group at every world size
that has one.
"""

from __future__ import annotations

import torch
import torch.distributed as td

from msom_tpu_torch.ops.bc import BC, _pad_axis
from msom_tpu_torch.ops.ghost import Ghosted
from msom_tpu_torch.parallel import dist


def _exchange(a: torch.Tensor, h: int, wrap: bool):
    """(up, dn): the last h rows of rank r - 1 and the first h rows of rank
    r + 1 (axis -2); zeros where a wall has no neighbour."""
    W, r = dist.world_size(), dist.rank()
    if W == 1:
        if wrap:
            return a[..., -h:, :], a[..., :h, :]
        z = torch.zeros_like(a[..., :h, :])
        return z, z
    up = torch.zeros_like(a[..., :h, :])
    dn = torch.zeros_like(up)
    prev_ok, next_ok = wrap or r > 0, wrap or r < W - 1
    ops = []
    # sends in the order (next, prev), receives (prev, next): two messages
    # between one pair of ranks (W = 2, wrapped) then match in order
    if next_ok:
        ops.append(td.P2POp(td.isend, a[..., -h:, :].contiguous(),
                            (r + 1) % W))
    if prev_ok:
        ops.append(td.P2POp(td.isend, a[..., :h, :].contiguous(),
                            (r - 1) % W))
        ops.append(td.P2POp(td.irecv, up, (r - 1) % W))
    if next_ok:
        ops.append(td.P2POp(td.irecv, dn, (r + 1) % W))
    for req in td.batch_isend_irecv(ops):
        req.wait()
    return up, dn


def ext_rows8(a: torch.Tensor, wrap: bool = False) -> torch.Tensor:
    """cat([up8, a, dn8], axis=-2): the shard extended with the 8-row halo
    slabs of its y-neighbours, the input layout of the rows mode of K1 and
    K2 (fused_rhs.rhs_fused, fused_tracer.tracer_fused). At a wall that is
    not wrapped the slab is zeros and is never read: the kernels' wall rules
    key on the global row. The shard needs 8 rows at least."""
    if a.shape[-2] < 8:
        raise ValueError(f"ext_rows8: a shard of {a.shape[-2]} rows, 8 at "
                         "least")
    up, dn = _exchange(a, 8, wrap)
    return torch.cat([up, a, dn], dim=-2).contiguous()


def split_rows8(a: torch.Tensor, world: int, wrap: bool = False) -> list:
    """The `ext_rows8` of every rank of a `world`-way rows decomposition of
    the whole field `a`, made on one process (virtual shards: for holding
    the rows mode of a kernel against its whole-field launch)."""
    N = a.shape[-2]
    n = N // world
    if n * world != N or n < 8:
        raise ValueError(f"split_rows8: {N} rows in {world} shards of 8 "
                         "rows or more")
    out = []
    for d in range(world):
        rows = torch.arange(d * n - 8, (d + 1) * n + 8, device=a.device)
        ext = a.index_select(a.ndim - 2, rows % N)
        if not wrap:
            ext[..., (rows < 0) | (rows >= N), :] = 0
        out.append(ext.contiguous())
    return out


def ghosted_rows(a: torch.Tensor, bc: BC) -> Ghosted:
    """The shard with its ghost ring (ops.ghost.ghosted of the whole field,
    cut to the shard): the ghost rows of an interior shard edge are the
    neighbours' rows, at a wall the rule of `bc`; x takes its rule on every
    row, ghost rows included, so corners compose x after y as ops.bc.pad
    does."""
    wrap = bc is BC.PERIODIC
    up, dn = _exchange(a, 1, wrap)
    if not wrap:
        sign = 1.0 if bc is BC.NEUMANN else -1.0
        if dist.rank() == 0:
            up = sign * a[..., :1, :]
        if dist.rank() == dist.world_size() - 1:
            dn = sign * a[..., -1:, :]
    return Ghosted(_pad_axis(torch.cat([up, a, dn], dim=-2), bc, -1))


def pmax(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over the ranks (the CFL maxima)."""
    if not dist.active():
        return x
    x = x.clone()
    td.all_reduce(x, op=td.ReduceOp.MAX)
    return x


def psum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks (the KE partials)."""
    if not dist.active():
        return x
    x = x.clone()
    td.all_reduce(x, op=td.ReduceOp.SUM)
    return x
