"""Carry a model state between the JAX package and the port.

`msom_tpu.io.checkpoint.save_state` writes every non-None leaf of a JAX
`QGState` into one .npz. `state_from_numpy` takes that mapping (e.g.
`np.load(path)`) and builds the port's `QGState`, so a JAX run resumes in
the port; `state_to_numpy` is its inverse. msqg has no learned weights:
every constant is derived from the config by `build_constants`.

The `key` leaf, the JAX PRNG key, is ignored: only stochastic forcing draws
from it, and a jax.random stream cannot be continued in torch; the port's
stochastic step draws from the torch.Generator given to `qg.make_step`. The `tracers` leaf (nl, nptr, N, N), the multigrid warm
start's `psi_old` leaf (nl, N, N) and, with the wavelet filter (dtflt >
0), its mean PV flux `qof` (nl, N, N) and event count `nbar` are carried
where the run has them, so a JAX run that has had filter events resumes in
the port with the same running mean.

`node_state_from_numpy` and `node_state_to_numpy` do the same for the
qg-node family's `NodeQGState` (leaves q, psi, t, dt_prev, i, nbar and,
with dtflt > 0, the filter mean psi_f, on the (nl, N+1, N+1) vertex grid,
or the (nl, N, N) owned nodes of the periodic grid, bc_fac = -1).
The node model has no learned weights either: its constants come from the
config and the numpy mask, psi_pg, topo, q_forcing_3d and N2 arrays given
to `qg_node.build_constants`. A vertex-sharded run's owned (nl, N, N)
fields take their ring row and column N back through
`parallel.vshard.to_full` (q with its `VertexRing`) before this path, and
`vshard.owned_state` cuts the port's state to the owned rep again; the
sharded runs take and return whole states.

`pg_state_from_numpy` and `pg_state_to_numpy` carry the mspg family's
`PGState` (leaves b, ux, uy, t, dt_prev, i, b_me, ux_me, uy_me, nme), so a
JAX mspg run resumes in the port and back. mspg has no learned weights:
its constants come from the config and the numpy `b_forc` given to
`mspg.build_constants`.

`newqg_state_from_numpy`/`newqg_state_to_numpy` carry newqg's
`NewQGState` (leaves q, psi, t, dt_prev, i on the (nl, N, N) cells) and
`sqg_state_from_numpy`/`sqg_state_to_numpy` the SQG variant's `SQGState`
(leaves q, psi (nl, N+1, N+1), bs (N+1, N+1), t, dt_prev, i; the `key`
leaf is ignored), so a JAX run of either resumes in the port and back.
"""

from __future__ import annotations

import numpy as np
import torch

from msom_tpu_torch.models import mspg, newqg, qg_node, sqg
from msom_tpu_torch.models.qg import QGState, _torch_dtype
from msom_tpu_torch.params import PGConfig, QGConfig


def state_from_numpy(cfg: QGConfig, leaves, device="cuda") -> QGState:
    """The port's QGState on `device` from a mapping of numpy arrays with
    the leaves q, psi, t, dt_prev, i and, where the run has them, tracers,
    psi_old, qof and nbar (as `save_state` writes them)."""
    dtype = _torch_dtype(cfg)
    shape = (cfg.nl, cfg.N, cfg.N)

    def field(name, shape=shape):
        a = np.asarray(leaves[name])
        if a.shape != shape:
            raise ValueError(f"leaf {name!r} has shape {a.shape}, the "
                             f"config needs {shape}")
        return torch.as_tensor(a, dtype=dtype).to(device)

    def scalar(name, dt):
        return torch.as_tensor(np.asarray(leaves[name]), dtype=dt).to(device)

    if ("tracers" in leaves) != (cfg.nptr > 0):
        raise ValueError(f"the config has nptr = {cfg.nptr} but the leaves "
                         f"{'hold' if 'tracers' in leaves else 'lack'} "
                         "tracers")
    tracers = field("tracers", (cfg.nl, cfg.nptr, cfg.N, cfg.N)) \
        if cfg.nptr > 0 else None
    extrap = cfg.solver == "mg" and cfg.mg_extrap
    if ("psi_old" in leaves) != extrap:
        raise ValueError(f"the config {'has' if extrap else 'has no'} mg "
                         f"warm-start extrapolation but the leaves "
                         f"{'hold' if 'psi_old' in leaves else 'lack'} "
                         "psi_old")
    filt = cfg.dtflt > 0
    if {"qof", "nbar"} & set(leaves) != ({"qof", "nbar"} if filt else set()):
        raise ValueError(f"the config {'has' if filt else 'has no'} filter "
                         f"(dtflt = {cfg.dtflt}) but the leaves hold "
                         f"{sorted({'qof', 'nbar'} & set(leaves))} of qof "
                         "and nbar")
    return QGState(q=field("q"), psi=field("psi"), t=scalar("t", dtype),
                   dt_prev=scalar("dt_prev", dtype),
                   i=scalar("i", torch.int32), tracers=tracers,
                   psi_old=field("psi_old") if extrap else None,
                   qof=field("qof") if filt else None,
                   nbar=scalar("nbar", torch.int32) if filt else None)


def state_to_numpy(state: QGState) -> dict:
    """The leaves of `state` as host numpy arrays, in save_state's names."""
    names = ("q", "psi", "t", "dt_prev", "i") + tuple(
        name for name in ("tracers", "psi_old", "qof", "nbar")
        if getattr(state, name) is not None)
    return {name: getattr(state, name).cpu().numpy() for name in names}


def node_state_from_numpy(cfg: qg_node.NodeQGConfig, leaves,
                          device="cuda") -> qg_node.NodeQGState:
    """The port's NodeQGState on `device` from a mapping of numpy arrays
    with the leaves q, psi, t, dt_prev, i, nbar and, where the run has a
    filter (dtflt > 0), psi_f; the `key` leaf is ignored. The fields are
    (nl, N+1, N+1), or (nl, N, N) on the periodic grid."""
    dtype = qg_node._torch_dtype(cfg)
    n = cfg.N if cfg.periodic else cfg.N + 1
    shape = (cfg.nl, n, n)

    def field(name):
        a = np.asarray(leaves[name])
        if a.shape != shape:
            raise ValueError(f"leaf {name!r} has shape {a.shape}, the "
                             f"config needs {shape}")
        return torch.as_tensor(a, dtype=dtype).to(device)

    def scalar(name, dt):
        return torch.as_tensor(np.asarray(leaves[name]), dtype=dt).to(device)

    filt = cfg.dtflt > 0
    if ("psi_f" in leaves) != filt:
        raise ValueError(f"the config {'has' if filt else 'has no'} filter "
                         f"(dtflt = {cfg.dtflt}) but the leaves "
                         f"{'hold' if 'psi_f' in leaves else 'lack'} psi_f")
    return qg_node.NodeQGState(
        q=field("q"), psi=field("psi"),
        psi_f=field("psi_f") if filt else None, t=scalar("t", dtype),
        dt_prev=scalar("dt_prev", dtype), i=scalar("i", torch.int32),
        nbar=scalar("nbar", torch.int32))


def node_state_to_numpy(state: qg_node.NodeQGState) -> dict:
    """The leaves of a NodeQGState as host numpy arrays, in save_state's
    names."""
    names = ("q", "psi", "t", "dt_prev", "i", "nbar") \
        + (("psi_f",) if state.psi_f is not None else ())
    return {name: getattr(state, name).cpu().numpy() for name in names}


PG_LEAVES = ("b", "ux", "uy", "t", "dt_prev", "i", "b_me", "ux_me", "uy_me",
             "nme")


def _leaves_to_tensors(leaves, shapes: dict, dtype, device,
                       ints=("i",)) -> dict:
    """{name: tensor on `device`} for the names of `shapes` (() a 0-d
    leaf), int32 for the names in `ints`, else `dtype`; raises on a shape
    mismatch."""
    out = {}
    for name, want in shapes.items():
        a = np.asarray(leaves[name])
        if a.shape != want:
            raise ValueError(f"leaf {name!r} has shape {a.shape}, the "
                             f"config needs {want}")
        dt = torch.int32 if name in ints else dtype
        out[name] = torch.tensor(a, dtype=dt, device=device)
    return out


def pg_state_from_numpy(cfg: PGConfig, leaves, device="cuda") -> mspg.PGState:
    """The port's PGState on `device` from a mapping of numpy arrays with
    the leaves of PG_LEAVES: b, b_me (nl, N, N); ux, ux_me (nl, N, N+1);
    uy, uy_me (nl, N+1, N); the 0-d t, dt_prev, i and nme."""
    nl, N = cfg.nl, cfg.N
    fields = {"b": (nl, N, N), "ux": (nl, N, N + 1), "uy": (nl, N + 1, N)}
    shapes = {n: fields.get(n.removesuffix("_me"), ()) for n in PG_LEAVES}
    return mspg.PGState(**_leaves_to_tensors(
        leaves, shapes, _torch_dtype(cfg), device, ints=("i", "nme")))


def pg_state_to_numpy(state: mspg.PGState) -> dict:
    """The leaves of a PGState as host numpy arrays."""
    return {name: getattr(state, name).cpu().numpy() for name in PG_LEAVES}


NEWQG_LEAVES = ("q", "psi", "t", "dt_prev", "i")
SQG_LEAVES = ("q", "bs", "psi", "t", "dt_prev", "i")


def newqg_state_from_numpy(cfg: newqg.NewQGConfig, leaves,
                           device="cuda") -> newqg.NewQGState:
    """The port's NewQGState on `device` from a mapping of numpy arrays
    with the leaves of NEWQG_LEAVES: q, psi (nl, N, N); the 0-d t,
    dt_prev, i."""
    field = (cfg.nl, cfg.N, cfg.N)
    shapes = {n: field if n in ("q", "psi") else () for n in NEWQG_LEAVES}
    return newqg.NewQGState(**_leaves_to_tensors(
        leaves, shapes, newqg._torch_dtype(cfg), device))


def newqg_state_to_numpy(state: newqg.NewQGState) -> dict:
    """The leaves of a NewQGState as host numpy arrays."""
    return {n: getattr(state, n).cpu().numpy() for n in NEWQG_LEAVES}


def sqg_state_from_numpy(cfg: qg_node.NodeQGConfig, leaves,
                         device="cuda") -> sqg.SQGState:
    """The port's SQGState on `device` from a mapping of numpy arrays with
    the leaves of SQG_LEAVES: q, psi (nl, N+1, N+1), bs (N+1, N+1); the
    0-d t, dt_prev, i. The `key` leaf is ignored."""
    M = cfg.N + 1
    shapes = {n: () for n in SQG_LEAVES}
    shapes.update(q=(cfg.nl, M, M), psi=(cfg.nl, M, M), bs=(M, M))
    return sqg.SQGState(**_leaves_to_tensors(
        leaves, shapes, qg_node._torch_dtype(cfg), device))


def sqg_state_to_numpy(state: sqg.SQGState) -> dict:
    """The leaves of an SQGState as host numpy arrays."""
    return {n: getattr(state, n).cpu().numpy() for n in SQG_LEAVES}
