"""The process group of a distributed run (the port of
`msom_tpu.parallel.dist`, over torch.distributed).

`init(device)` starts the group from torchrun's environment (RANK,
WORLD_SIZE, MASTER_ADDR/MASTER_PORT) or from explicit arguments; with
neither, the run has no group and is world size 1, and every collective of
`parallel/` is then the identity. The backend follows the device: NCCL for
CUDA, gloo for the CPU. A CUDA run without NCCL raises: there is no
fallback to gloo or to the CPU. A group of world size 1 is a real group:
its collectives run through NCCL or gloo like any other.

The writers of a distributed run (the drivers' outputs) run on the master,
rank 0, from `fetch_global`, which gathers the row shards of a field into
the whole field on every rank. `subgroup(ranks)` is the process group of
some ranks (a row or a column of a 2-D mesh, parallel/mesh.py), made once
and kept until `shutdown`.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as td


def init(device="cuda", *, init_method: str | None = None,
         world_size: int | None = None, rank: int | None = None) -> bool:
    """Start the process group for `device` unless one is running; returns
    whether a group runs. `init_method` (with `world_size` and `rank`), for
    example "file:///tmp/store" or "tcp://localhost:29500", starts it
    explicitly; without it torchrun's environment does, and where that is
    absent too the run is world size 1 without a group. On CUDA each rank
    takes the card LOCAL_RANK (else its rank modulo the cards)."""
    if td.is_initialized():
        return True
    env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if init_method is None and not env:
        return False
    cuda = torch.device(device).type == "cuda"
    if cuda and not td.is_nccl_available():
        raise RuntimeError("a CUDA run needs the NCCL backend, which this "
                           "torch build lacks")
    if init_method is None:
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    if cuda:
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    td.init_process_group("nccl" if cuda else "gloo",
                          init_method=init_method, world_size=world_size,
                          rank=rank)
    return True


_groups: dict = {}


def subgroup(ranks) -> td.ProcessGroup:
    """The process group of `ranks` (td.new_group), made at its first call
    and kept until `shutdown`. new_group is collective: every rank of the
    world asks for every subgroup, in the same order."""
    ranks = tuple(ranks)
    if ranks not in _groups:
        _groups[ranks] = td.new_group(list(ranks))
    return _groups[ranks]


def shutdown() -> None:
    """End the process group, if one runs, and its subgroups."""
    _groups.clear()
    if td.is_initialized():
        td.destroy_process_group()


def active() -> bool:
    """Whether a process group runs (its collectives then go through it,
    at world size 1 too)."""
    return td.is_initialized()


def rank() -> int:
    return td.get_rank() if td.is_initialized() else 0


def world_size() -> int:
    return td.get_world_size() if td.is_initialized() else 1


def is_master() -> bool:
    """True on the process that writes files (rank 0)."""
    return rank() == 0


def broadcast_str(s: str | None) -> str | None:
    """The master's string on every rank (MPI_Bcast of the outdir name,
    msqg/qg.h:777-779); the identity without a group."""
    if not td.is_initialized():
        return s
    box = [s if is_master() else None]
    td.broadcast_object_list(box, src=0)
    return box[0]


def fetch_global(x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """The whole field from its row shards: the rank-ordered concatenation
    of every rank's `x` along `axis`, on every rank (all_gather); the
    writers then run on the master. The identity without a group."""
    if not td.is_initialized():
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(td.get_world_size())]
    td.all_gather(parts, x)
    return torch.cat(parts, dim=axis)


def sync() -> None:
    """A barrier across the ranks (none without a group)."""
    if td.is_initialized():
        td.barrier()
