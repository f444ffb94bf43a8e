"""Reading an msqg, a qg-node or an mspg experiment deck (the port's own
copy of `msom_tpu.io.deck.load_qg_deck`, `load_node_deck` and
`load_pg_deck`).

The reference driver reads a directory of input files beside params.in
(msqg/qg.c:53-92, qg.h:931-985):
    p0.bas                      initial streamfunction (else 1e-3 noise)
    ptr0.bas / ptr_relax.bas    tracer ICs / relaxation targets
    dh_<nl>l.bin                float32 layer thicknesses
    psipg_<nl>l_N<N>.bas        large-scale (PG) streamfunction
    frpg_<nl>l_N<N>.bas         Froude-number field (-> strl)
    rdpg_<nl>l_N<N>.bas         deformation radius (filter scale)
    topo.bas                    bottom topography
    qforc_<nl>l_N<N>.bas        3-D PV forcing
    s_stoch_<nl>l_N<N>.bas      stochastic sigma (qg_stochastic.h:163-171)

`load_qg_deck` returns the keyword arguments of `models.qg.build_constants`
and `init_state`, and reports each file it found (the reference prints
"<name> .. ok", qg.h:937-985).

A qg-node deck (qg-node/qg_baroclinic_ms.h:478-495) is one NetCDF file,
input_vars_<nl>l_N<N>.nc, with N2, psi_pg, mask, topo and q_forcing_3d on
the (N+1)^2 vertex grid (a static `q_forcing` there is read by the
reference too, but the wind event overwrites it before it is used,
qg-node/qg.c:136-145); `load_node_deck` returns the keyword arguments of
`models.qg_node.build_constants`. restart.nc is the node driver's
(driver_node.run_node).

An mspg deck (mspg/pg.c:133-155):
    b0.bas / u0.bas             initial buoyancy / velocity (the running-
                                mean dumps hold the 2 ghost sigma layers;
                                nl and nl+2 block counts are both taken)
    bf_pg.bas                   QG eddy buoyancy forcing
`load_pg_deck` returns the keyword arguments of `models.mspg.
build_constants` and `init_state`.
"""

from __future__ import annotations

import os

import numpy as np

from msom_tpu_torch.io.bas import read_bas


def _maybe_bas(path, nl=None):
    if os.path.exists(path):
        return read_bas(path, nl)[0]
    return None


def load_qg_deck(cfg, deckdir: str, *, log=None) -> dict:
    """Ingest an msqg deck directory. Returns {"const": kwargs of
    build_constants, "init": kwargs of init_state, "found": the file names
    read}."""
    nl, N = cfg.nl, cfg.N
    found = []

    def hit(name):
        found.append(name)
        if log is not None:
            log(f"{name} .. ok")

    const = {}
    p = os.path.join(deckdir, f"dh_{nl}l.bin")
    if os.path.exists(p):
        const["dh"] = np.fromfile(p, np.float32, nl).astype(np.float64)
        hit(os.path.basename(p))

    for key, name, n_read in (
            ("psipg", f"psipg_{nl}l_N{N}.bas", nl),
            ("frpg", f"frpg_{nl}l_N{N}.bas", max(nl - 1, 1)),
            ("rdpg", f"rdpg_{nl}l_N{N}.bas", 1),
            ("topo", "topo.bas", 1),
            ("qforc", f"qforc_{nl}l_N{N}.bas", nl),
            ("s_stoch", f"s_stoch_{nl}l_N{N}.bas", nl)):
        arr = _maybe_bas(os.path.join(deckdir, name), n_read)
        if arr is not None:
            const[key] = arr[0] if key in ("rdpg", "topo") else arr
            hit(name)

    init = {}
    psi0 = _maybe_bas(os.path.join(deckdir, "p0.bas"), nl)
    if psi0 is not None:
        init["psi0"] = psi0
        hit("p0.bas")
    if cfg.nptr > 0:
        tr = _maybe_bas(os.path.join(deckdir, "ptr0.bas"), nl * cfg.nptr)
        if tr is not None:
            # interleaved (l*nptr + nt) blocks
            # (msqg/scripts/init_ptracer.py:22-28)
            init["tracers0"] = tr.reshape(nl, cfg.nptr, N, N)
            hit("ptr0.bas")
        rel = _maybe_bas(os.path.join(deckdir, "ptr_relax.bas"),
                         nl * cfg.nptr)
        if rel is not None:
            const["ptr_relax"] = rel.reshape(nl, cfg.nptr, N, N)
            hit("ptr_relax.bas")
    return {"const": const, "init": init, "found": found}


def _read_nc_static(path, names):
    """Whole variables of a NetCDF file without a time axis, as float64;
    names the file lacks are skipped."""
    from scipy.io import netcdf_file
    out = {}
    with netcdf_file(path, "r", mmap=False) as f:
        for name in names:
            if name in f.variables:
                out[name] = np.array(f.variables[name][:], np.float64)
    return out


def load_node_deck(cfg, deckdir: str, *, log=None) -> dict:
    """Ingest a qg-node deck: input_vars_<nl>l_N<N>.nc. Returns {"const":
    kwargs of build_constants, "found": the file names read, "path": the
    file's path or None}."""
    nl, N = cfg.nl, cfg.N
    name = f"input_vars_{nl}l_N{N}.nc"
    path = os.path.join(deckdir, name)
    if not os.path.exists(path):
        return {"const": {}, "found": [], "path": None}
    const = _read_nc_static(path, ["N2", "psi_pg", "mask", "topo",
                                   "q_forcing_3d"])
    if log is not None:
        log(f"{name} .. ok ({', '.join(sorted(const))})")
    return {"const": const, "found": [name], "path": path}


def _faces_from_bas(blocks, N, axis):
    """(nl, N, N) cell-anchored face values -> (nl, N, N+1) or (nl, N+1, N)
    face arrays; the trailing wall face (no interior neighbour) is a solid
    boundary, u_normal = 0."""
    nl = blocks.shape[0]
    if axis == "x":
        out = np.zeros((nl, N, N + 1), blocks.dtype)
        out[:, :, :N] = blocks
    else:
        out = np.zeros((nl, N + 1, N), blocks.dtype)
        out[:, :N, :] = blocks
    return out


def _strip_ghost_layers(arr, nl):
    """Take nl or nl+2 sigma-layer blocks (the state dumps hold the two
    vertical ghost layers, mspg/pg.h:374-387)."""
    if arr.shape[0] == nl + 2:
        return arr[1:-1]
    if arr.shape[0] == nl:
        return arr
    raise ValueError(f"expected {nl} or {nl + 2} layer blocks, "
                     f"got {arr.shape[0]}")


def load_pg_deck(cfg, deckdir: str, *, log=None) -> dict:
    """Ingest an mspg deck (b0.bas, u0.bas, bf_pg.bas). Returns {"const":
    kwargs of build_constants, "init": kwargs of init_state, "found": the
    file names read}."""
    nl, N = cfg.nl, cfg.N
    found = []

    def hit(name):
        found.append(name)
        if log is not None:
            log(f"{name} .. ok")

    const, init = {}, {}
    b0 = _maybe_bas(os.path.join(deckdir, "b0.bas"))
    if b0 is not None:
        init["b0"] = _strip_ghost_layers(b0, nl)
        hit("b0.bas")
    u0 = _maybe_bas(os.path.join(deckdir, "u0.bas"))
    if u0 is not None:
        # the (scalar *) ul flattening: [l0.x, l0.y, l1.x, l1.y, ...]
        # (mspg/pg.c:144-147; the output u%09d.bas, pg.c:222-226)
        if u0.shape[0] not in (2 * nl, 2 * (nl + 2)):
            raise ValueError(f"u0.bas: expected {2 * nl} or {2 * (nl + 2)} "
                             f"blocks, got {u0.shape[0]}")
        pairs = u0.reshape(-1, 2, N, N)
        init["u0"] = (
            _faces_from_bas(_strip_ghost_layers(pairs[:, 0], nl), N, "x"),
            _faces_from_bas(_strip_ghost_layers(pairs[:, 1], nl), N, "y"))
        hit("u0.bas")
    bf = _maybe_bas(os.path.join(deckdir, "bf_pg.bas"))
    if bf is not None:
        const["b_forc"] = _strip_ghost_layers(bf, nl)
        hit("bf_pg.bas")
    return {"const": const, "init": init, "found": found}
