"""Fused msqg tendency: kernel K1 of the port.

`rhs_fused(cfg, const, psi, q=None) -> (dq, umax)` computes what the JAX
package's Pallas kernel (`msom_tpu.models.pallas_rhs.rhs_fused`,
`_rhs_kernel`) computes: the whole update_qg tendency, with the options the
constants and the config switch on (the large-scale streamfunction pp and
its cascade cross terms, _LS_RV, topography, the 3-D forcing, ENERGY_CONSERV
advection of `q`, the stochastic variant, which reads `q` too, partial-slip
ghosts, the doubly periodic domain), and the (nl,) per-layer maximum |face
velocity| of psi for the CFL controller (the pp part of that chain is
const.umax_pp, made at build). In the periodic run the kernel reads pp and
zetap padded (const.pp_t, const.zetap_t: pp_pad and zetap_pad, widened for
aligned copies), their ghosts made at build: pp's follow the reference's
non-wrap law, zetap's wrap.

Rows mode (`psi_ext=`, `q_ext=`, `row0=`, the JAX kernel's rows layout,
pallas_rhs.py:640-737): psi is one shard (nl, n_loc, N) of a rows
decomposition, the output rows [row0, row0 + n_loc) of the domain;
psi_ext (and q_ext) is the shard with the 8-row halo slabs of its
y-neighbours, `parallel/halo.ext_rows8`. The walls apply at the global rows
0 and N - 1; the constants stay whole and are read at the global rows. dq
is the shard's (nl, n_loc, N) and umax the shard's maxima (the caller
reduces them over the ranks).

On a CUDA tensor it launches the hand-written Hopper kernel in
`csrc/fused_rhs.cu` (the rows mode: `csrc/fused_rhs_rows.cu`, the same
source built with its rows constant on; built at first use by `_build`,
bound with ctypes) or raises. On a CPU tensor it computes the plain
PyTorch version, `rhs_fused_reference`, built from `qg.rhs` and
`max_face_speed_layers`. `launches` counts kernel launches,
`rows_launches` those in rows mode.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from msom_tpu_torch import _build
from msom_tpu_torch.ops.ghost import (Ghosted, ghosted, laplacian_g,
                                      max_face_speed_layers)

SOURCE = "msom_tpu_torch/csrc/fused_rhs.cu"
# the rows mode: fused_rhs.cu built with its rows constant on
ROWS_SOURCE = "msom_tpu_torch/csrc/fused_rhs_rows.cu"
SMEM_LIMIT = 232448          # shared memory one block may use on sm_90
MIN_PERIODIC_N = 4           # the periodic halo wraps once

launches = 0
rows_launches = 0       # of them in rows mode


# rows of halo a shard's plain version computes beyond its own: the
# biharmonic reads psi 3 rows away, so a wrong ghost at the window's edge
# reaches no output row
WINDOW_HALO = 3


def rhs_fused_reference(cfg, const, psi: torch.Tensor,
                        q: torch.Tensor | None = None, *, psi_ext=None,
                        q_ext=None, row0=None):
    """The plain PyTorch version: (dq, umax) from qg.rhs and
    max_face_speed_layers under the config's ghost law, on any device; in
    rows mode the same on the shard's window (`shard_window`)."""
    from msom_tpu_torch.models import qg
    if psi_ext is not None:
        win = shard_window(cfg, const, psi_ext, q_ext, row0, psi.shape[-2])
        cfg, const, psi, q, out = win
    psi_g = ghosted(psi, qg._bc_psi(cfg))
    zeta = laplacian_g(psi_g, cfg.delta)
    dq, _ = qg.rhs(cfg, const, q, psi_g, zeta,
                   qg._ghost_deriv(cfg, zeta, psi_g))
    if psi_ext is None:
        return dq, max_face_speed_layers(psi_g, cfg.delta)
    # the faces of the shard's own cells: its rows with one ghost row each
    # side, the neighbours' rows or the wall's ghosts
    rows = psi_g.p[..., out.start:out.stop + 2, :]
    return (dq[..., out, :].contiguous(),
            max_face_speed_layers(Ghosted(rows), cfg.delta))


def window_rows(cfg, row0: int, n_loc: int) -> range:
    """The global rows of a shard's window: its own rows and WINDOW_HALO
    rows of each neighbour's, cut at a wall (not at a periodic edge)."""
    h = WINDOW_HALO
    periodic = cfg.sbc == -1
    lo = row0 - h if periodic or row0 > 0 else row0
    hi = row0 + n_loc + h if periodic or row0 + n_loc < cfg.N \
        else row0 + n_loc
    return range(lo, hi)


def window_const(const, rows: range):
    """The constants that qg.rhs and qg.tracer_rhs read, cut to the global
    `rows` (a padded field with its ghost row either side). Rows past the
    grid of a periodic window take the edge rows' values: only the window's
    outer rows read them, and no output depends on those."""
    N = const.wind.shape[0]
    g = torch.arange(rows.start, rows.stop, device=const.wind.device)
    inner = g.clamp(0, N - 1)
    padded = torch.arange(rows.start, rows.stop + 2,
                          device=g.device).clamp(0, N + 1)

    def cut(t, idx, axis=-2):
        return None if t is None else t.index_select(t.ndim + axis, idx)

    strl = const.strl
    return dataclasses.replace(
        const, wind=cut(const.wind, inner), Ro=cut(const.Ro, inner),
        strl=None if strl is None else cut(strl, inner),
        pp_pad=cut(const.pp_pad, padded),
        zetap_pad=cut(const.zetap_pad, padded),
        topo_pad=cut(const.topo_pad, padded), qforc=cut(const.qforc, inner),
        ptr_relax=cut(const.ptr_relax, inner))


def shard_window(cfg, const, psi_ext, q_ext, row0: int, n_loc: int):
    """(cfg, const, psi, q, out) of a shard's window: psi (and q) on
    `window_rows`, cut from the halo-extended shard, the constants cut to
    those rows, and the slice of the window that is the shard's own rows.
    The window's edges away from a wall take the wall law of the whole
    grid, which is wrong there, but only up to WINDOW_HALO - 1 rows in."""
    rows = window_rows(cfg, row0, n_loc)
    a, b = rows.start - row0 + 8, rows.stop - row0 + 8
    out = slice(row0 - rows.start, row0 - rows.start + n_loc)
    q = None if q_ext is None else q_ext[..., a:b, :]
    return cfg, window_const(const, rows), psi_ext[..., a:b, :], q, out


@functools.cache
def _lib(rows: bool = False):
    """The built library (the rows mode's with `rows`) with its C
    signatures declared."""
    lib = _build.load("fused_rhs_rows" if rows else "fused_rhs")
    ptr = ctypes.c_void_p
    dbl = ctypes.POINTER(ctypes.c_double)
    for fn in (lib.fused_rhs_f32, lib.fused_rhs_f64):
        fn.argtypes = [ctypes.POINTER(ptr), ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, dbl, dbl, dbl, ctypes.c_int,
                       ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
    lib.fused_rhs_num_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fused_rhs_num_blocks.restype = ctypes.c_int
    lib.fused_rhs_smem_bytes.argtypes = [ctypes.c_int] * 7
    lib.fused_rhs_smem_bytes.restype = ctypes.c_longlong
    lib.fused_rhs_error_string.argtypes = [ctypes.c_int]
    lib.fused_rhs_error_string.restype = ctypes.c_char_p
    return lib


def _doubles(vals):
    return (ctypes.c_double * len(vals))(*vals)


# bits of the launch's `flags`, csrc/fused_rhs.cu's `Flag`
FLSRV, PERIODIC, STOCHASTIC, ROWS = 1, 2, 4, 8


def _options(cfg, const):
    """The kernel's options from the config and the constants:
    (pp, zetap, topo, iro, qforc, need_q, cslip, flags). The advection
    block, pp terms and the stochastic damping included, does not run at
    nl == 1, so pp and q are dropped there. pp is the interior of pp_pad
    with walls, pp_t (pp_pad widened) in the periodic run, where zetap_t
    comes with it (_LS_RV); with walls the kernel makes zetap itself."""
    periodic = cfg.sbc == -1
    has_pg = const.pp is not None and cfg.nl > 1
    flsrv = bool(has_pg and const.zetap_pad is not None)
    stoch = bool(cfg.stochastic and cfg.nl > 1)
    cslip = cfg.sbc / ((0.5 * cfg.sbc + 1.0) * cfg.delta ** 2) \
        if cfg.sbc > 0 else 0.0
    pp = None
    if has_pg:
        pp = const.pp_t if periodic else const.pp
    flags = (FLSRV * flsrv) | (PERIODIC * periodic) | (STOCHASTIC * stoch)
    return (pp, const.zetap_t if flsrv and periodic else None,
            const.topo, const.iro, const.qforc,
            bool((cfg.energy_conserv or cfg.stochastic) and cfg.nl > 1),
            cslip, flags)


def rhs_fused(cfg, const, psi: torch.Tensor, q: torch.Tensor | None = None,
              *, psi_ext=None, q_ext=None, row0=None):
    """(dq, umax): the kernel on a CUDA tensor, the plain version on a CPU
    tensor. `q` (in rows mode `q_ext`) is needed for ENERGY_CONSERV
    advection and the stochastic variant only."""
    global launches, rows_launches
    rows = psi_ext is not None
    nl, N = cfg.nl, cfg.N
    ny = psi.shape[-2] if rows else N
    if rows and not (row0 is not None and 0 <= row0 <= N - ny):
        raise ValueError(f"rhs_fused: rows mode needs 0 <= row0 <= "
                         f"{N - ny}, got {row0}")
    if psi.device.type == "cpu":
        return rhs_fused_reference(cfg, const, psi, q, psi_ext=psi_ext,
                                   q_ext=q_ext, row0=row0)
    if psi.device.type != "cuda":
        raise ValueError(f"rhs_fused: unsupported device {psi.device}")
    if psi.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"rhs_fused: dtype {psi.dtype} (float32 or float64)")
    # in rows mode the kernel reads psi_ext, and psi gives the shard's rows
    if tuple(psi.shape) != (nl, ny, N) or not (rows or psi.is_contiguous()):
        raise ValueError(f"rhs_fused: psi must be a contiguous {(nl, ny, N)} "
                         f"tensor, got {tuple(psi.shape)}")
    pp, zetap, topo, iro, qforc, need_q, cslip, flags = _options(cfg, const)
    src, q_src = (psi_ext, q_ext) if rows else (psi, q)
    if need_q and q_src is None:
        raise ValueError("rhs_fused: ENERGY_CONSERV advection or the "
                         "stochastic variant needs q (q_ext in rows mode)")
    if flags & PERIODIC and N < MIN_PERIODIC_N:
        raise ValueError(f"rhs_fused: the periodic kernel takes N >= "
                         f"{MIN_PERIODIC_N}, got {N}")
    ppn, pps = ("const.pp_t", (nl, N + 2, N + 8)) if flags & PERIODIC \
        else ("const.pp", (nl, N, N))
    fields = [("const.wind", const.wind, (N, 1)), (ppn, pp, pps),
              ("const.zetap_t", zetap, (nl, N + 2, N + 8)),
              ("const.topo", topo, (N, N)), ("const.iro", iro, (N, 1)),
              ("const.qforc", qforc, (nl, N, N)),
              ("q_ext" if rows else "q", q_src if need_q else None,
               (nl, ny + 16 * rows, N))]
    if rows:
        fields.append(("psi_ext", src, (nl, ny + 16, N)))
    if nl > 1:
        fields.append(("const.strl", const.strl, (nl - 1, N, 1)))
    for name, t, shape in fields:
        if t is None and name not in ("const.wind", "const.strl",
                                      "psi_ext"):
            continue
        if (t is None or tuple(t.shape) != shape or t.device != psi.device
                or t.dtype != psi.dtype or not t.is_contiguous()):
            raise ValueError(f"rhs_fused: {name} must be a contiguous "
                             f"{psi.dtype} tensor {shape} on {psi.device}")
    lib = _lib(rows)
    smem = lib.fused_rhs_smem_bytes(nl, psi.element_size(),
                                    int(pp is not None), int(flags & FLSRV),
                                    int(need_q), int(topo is not None),
                                    int(flags & PERIODIC))
    if smem > SMEM_LIMIT:
        raise ValueError(f"rhs_fused: nl = {nl} with these options needs "
                         f"{smem} B of shared memory per block, more than "
                         f"{SMEM_LIMIT}")
    dq = torch.empty(psi.shape, dtype=psi.dtype, device=psi.device)
    umax_part = torch.empty((lib.fused_rhs_num_blocks(N, ny), nl),
                            dtype=psi.dtype, device=psi.device)
    with torch.cuda.device(psi.device):
        stream = torch.cuda.current_stream(psi.device).cuda_stream
        rc = launch(lib, cfg, const, src, q_src, dq, umax_part, stream,
                    row0=row0 if rows else None)
    if rc != 0:
        raise RuntimeError("fused_rhs launch failed: "
                           + lib.fused_rhs_error_string(rc).decode())
    launches += 1
    rows_launches += rows
    return dq, umax_part.amax(dim=0)


def launch(lib, cfg, const, psi, q, dq, umax_part, stream,
           row0: int | None = None) -> int:
    """Call the library's C entry for psi's type with this configuration's
    fields and scalars, writing dq and the per-block maxima umax_part
    (fused_rhs_num_blocks(N, ny), nl) on `stream`; returns its error code.
    With `row0` the rows mode: psi and q are the halo-extended shard
    (nl, ny + 16, N) of the output rows [row0, row0 + ny), dq (nl, ny, N).
    The caller has checked the fields (rhs_fused), or runs the kernel's
    source in a host emulation (tools/k1_emulation.py)."""
    nl = cfg.nl
    pp, zetap, topo, iro, qforc, need_q, cslip, flags = _options(cfg, const)
    if row0 is not None:
        flags |= ROWS
    dh = cfg.dh
    scal = _doubles([cfg.delta, cfg.beta, cfg.iRe, cfg.iRe4,
                     cfg.Eks / (cfg.Rom * 2 * dh[0]),
                     cfg.Ekb / (cfg.Rom * 2 * dh[nl - 1]), cslip,
                     cfg.itr_stoch])
    fn = lib.fused_rhs_f32 if psi.dtype == torch.float32 \
        else lib.fused_rhs_f64
    # the order of csrc/fused_rhs.cu's `Ptr` enumeration; absent fields null
    tensors = [psi, const.strl if nl > 1 else None, const.wind, dq, umax_part,
               pp, q if need_q else None, topo, iro, qforc, zetap]
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
    return fn(ptrs, cfg.N, nl, flags, scal, _doubles(const.idh0),
              _doubles(const.idh1), row0 or 0, dq.shape[-2], stream)


def bound_work(cfg, const, itemsize: int, rows=None):
    """(bytes, operations) that the tendency needs at least: every input
    field read once (psi and, where the options bring them, pp, q, topo,
    qforc; the periodic run's pp with its ghost ring, (N + 2)^2 a layer),
    dq written once,
    plus the y-profiles read and the (nl,) maxima written, and the
    arithmetic counted per cell and layer from the formula, not from the
    kernel's redundant halo work. zetap, which the periodic kernel reads
    where the walled one computes it, counts as computed. With `rows`
    (row0, ny), the rows launch of that shard: its ny rows of output, and
    of the inputs the rows its outputs read, 3 more of psi and q and 1
    more of pp and topo at each edge that is not a wall. Used for the
    roofline bound."""
    N, nl = cfg.N, cfg.nl
    pp, _, topo, _, qforc, need_q, cslip, flags = _options(cfg, const)
    flsrv = bool(flags & FLSRV)
    stoch = bool(flags & STOCHASTIC)
    ny, edges = N, 0
    if rows is not None:
        row0, ny = rows
        per = bool(flags & PERIODIC)
        edges = int(per or row0 > 0) + int(per or row0 + ny < N)
    cells = ny * N * nl
    psi_rows = (ny + 3 * edges) * N
    planes = nl * (2 if need_q else 1) * psi_rows + nl * ny * N \
        + ((ny + edges) * N if topo is not None else 0) \
        + (nl * ny * N if qforc is not None else 0)
    if pp is None:
        pp_cells = 0
    elif flags & PERIODIC:
        pp_cells = nl * (ny + 2) * (N + 2)
    else:
        pp_cells = nl * (ny + edges) * N
    nbytes = (planes + pp_cells + ny * nl + nl
              + (ny if topo is not None else 0)) * itemsize
    gamma = 8 if nl > 1 else 0   # Gamma(.) at one cell
    jac = 32                     # one 12-point Arakawa bracket
    ops = 6 + 27 + 4             # zeta Laplacian, face speeds, wind/Ekman
    if nl > 1:
        ops += jac + 3 + 6       # self advection, beta, cascade weights
        if not need_q:
            ops += jac           # interface -J(psi_l, psi_l+1)
        if stoch:
            ops += 2             # -q / tr_stoch
        if pp is not None:
            ops += 3 * jac + 3   # -J(pp, zeta) and the two cross terms
        if flsrv:
            ops += 6 + jac + 1   # zetap = lap pp, -J(psi, zetap)
    if cfg.iRe != 0.0 or cfg.iRe4 != 0.0:
        ops += 6                 # tmp = lap zeta
    if cfg.iRe != 0.0:
        ops += 2 + gamma
    if cfg.iRe4 != 0.0:
        ops += 6 + 2 + gamma     # lap tmp
    total = ops * cells
    if stoch:
        total -= jac * ny * N    # no self advection in the top layer
    if topo is not None:
        total += (jac + 2) * ny * N     # bottom layer only
    if qforc is not None:
        total += cells
    return nbytes, total
