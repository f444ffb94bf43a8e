"""Fused passive-tracer tendency: kernel K2 of the port.

`tracer_fused(cfg, const, psi, tracers) -> dtr` computes what the JAX
package's Pallas kernel (`msom_tpu.models.pallas_rhs.tracer_fused`,
`_tracer_kernel`) computes: for the (nl, nptr, N, N) tracers,
dtr = -J(psi_l, c) + iPe_j lap(c) + ir_j (relax - c) (ptr_rhs,
msqg/qg.h:573-588), with Neumann tracer ghosts and Dirichlet psi ghosts on
a walled domain, and everything wrapped on the doubly periodic one
(sbc = -1).

Rows mode (`psi_ext=`, `tr_ext=`, `row0=`, pallas_rhs.py:820-872): psi
and the tracers are one shard of rows [row0, row0 + n_loc), psi_ext and
tr_ext the shard with its neighbours' 8-row halo slabs
(`parallel/halo.ext_rows8`; tr_ext of the flattened (nl * nptr, n_loc, N)
tracers); the walls apply at the global rows, the relaxation field stays
whole, and dtr is the shard's.

On a CUDA tensor it launches the hand-written Hopper kernel in
`csrc/fused_tracer.cu` (the rows mode: `csrc/fused_tracer_rows.cu`, the
same source built with its rows constant on), a strip that marches down y
on the grid and
shared memory that `launch_geometry` gives it (built at first use by
`_build`, bound with ctypes), or raises. On a CPU tensor it computes the
plain PyTorch version, `tracer_fused_reference`, the tracer block of
`qg.rhs`. `launches` counts kernel launches, `rows_launches` those in
rows mode.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from msom_tpu_torch import _build
from msom_tpu_torch.ops.ghost import ghosted

SOURCE = "msom_tpu_torch/csrc/fused_tracer.cu"
# the rows mode: fused_tracer.cu built with its rows constant on
ROWS_SOURCE = "msom_tpu_torch/csrc/fused_tracer_rows.cu"

# The strip of csrc/fused_tracer.cu: TX columns (one thread each) by SY rows
# of one layer, and a ring of RING rows of TX + 2 XH columns for psi_l and
# each tracer of the layer in shared memory. SY is chosen here; TX, RING and
# XH are the kernel's, whose launch refuses a geometry that does not fit
# them.
TX, SY, RING, XH = 128, 32, 8, 4
MIN_PERIODIC_N = 4           # the periodic halo wraps once

launches = 0
rows_launches = 0       # of them in rows mode


def strips(n: int, width: int) -> list[tuple[int, int]]:
    """The [start, stop) ranges of the strips that cover 0 .. n - 1: all
    `width` long but the last, which keeps the remainder."""
    return [(a, min(a + width, n)) for a in range(0, n, width)]


def launch_geometry(N: int, nl: int, nptr: int, itemsize: int,
                    ny: int | None = None):
    """(grid, threads a block, dynamic shared-memory bytes) of the kernel's
    launch, strips of SY rows, for N^2 planes (in rows mode ny output rows
    of them), nl layers and nptr tracers of `itemsize` bytes."""
    grid = (len(strips(N, TX)), len(strips(N if ny is None else ny, SY)),
            nl)
    return grid, TX, RING * (1 + nptr) * (TX + 2 * XH) * itemsize


def tracer_fused_reference(cfg, const, psi: torch.Tensor,
                           tracers: torch.Tensor, *, psi_ext=None,
                           tr_ext=None, row0=None) -> torch.Tensor:
    """The plain PyTorch version (qg.tracer_rhs), on any device; in rows
    mode on the shard's window (fused_rhs.shard_window)."""
    from msom_tpu_torch.models import fused_rhs, qg
    if psi_ext is None:
        return qg.tracer_rhs(cfg, const, ghosted(psi, qg._bc_psi(cfg)),
                             tracers)
    nl, nptr, n_loc, N = tracers.shape
    _, wconst, psi_w, tr_w, out = fused_rhs.shard_window(
        cfg, const, psi_ext, tr_ext, row0, n_loc)
    tr_w = tr_w.reshape(nl, nptr, -1, N)
    dtr = qg.tracer_rhs(cfg, wconst, ghosted(psi_w, qg._bc_psi(cfg)), tr_w)
    return dtr[..., out, :].contiguous()


# the C entries' arguments, csrc/fused_tracer.cu's `fused_tracer_f32`
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
    ctypes.c_double, ctypes.POINTER(ctypes.c_double),
    ctypes.POINTER(ctypes.c_double)] + [ctypes.c_int] * 3 + [
    ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]


@functools.cache
def _lib(rows: bool = False):
    """The built library (the rows mode's with `rows`) with its C
    signatures declared."""
    lib = _build.load("fused_tracer_rows" if rows else "fused_tracer")
    for fn in (lib.fused_tracer_f32, lib.fused_tracer_f64):
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    lib.fused_tracer_max_nptr.argtypes = []
    lib.fused_tracer_max_nptr.restype = ctypes.c_int
    lib.fused_tracer_error_string.argtypes = [ctypes.c_int]
    lib.fused_tracer_error_string.restype = ctypes.c_char_p
    return lib


def tracer_fused(cfg, const, psi: torch.Tensor, tracers: torch.Tensor, *,
                 psi_ext=None, tr_ext=None, row0=None) -> torch.Tensor:
    """dtr (nl, nptr, N, N), in rows mode (nl, nptr, n_loc, N): the kernel
    on a CUDA tensor, the plain version on a CPU tensor."""
    global launches, rows_launches
    rows = psi_ext is not None
    nl, N, nptr = cfg.nl, cfg.N, cfg.nptr
    ny = psi.shape[-2] if rows else N
    if rows and not (tr_ext is not None and row0 is not None
                     and 0 <= row0 <= N - ny):
        raise ValueError(f"tracer_fused: rows mode needs tr_ext and 0 <= "
                         f"row0 <= {N - ny}, got row0 = {row0}")
    if psi.device.type == "cpu":
        return tracer_fused_reference(cfg, const, psi, tracers,
                                      psi_ext=psi_ext, tr_ext=tr_ext,
                                      row0=row0)
    if psi.device.type != "cuda":
        raise ValueError(f"tracer_fused: unsupported device {psi.device}")
    if psi.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"tracer_fused: dtype {psi.dtype} (float32 or "
                        "float64)")
    fields = [("psi", psi, (nl, ny, N)),
              ("tracers", tracers, (nl, nptr, ny, N))]
    if rows:
        fields += [("psi_ext", psi_ext, (nl, ny + 16, N)),
                   ("tr_ext", tr_ext, (nl * nptr, ny + 16, N))]
    if const.ptr_relax is not None:
        fields.append(("const.ptr_relax", const.ptr_relax, (nl, nptr, N, N)))
    for name, t, shape in fields:
        # in rows mode the kernel reads the _ext tensors, and psi and the
        # tracers give the shard's shape
        dense = t.is_contiguous() or (rows and name in ("psi", "tracers"))
        if (tuple(t.shape) != shape or t.device != psi.device
                or t.dtype != psi.dtype or not dense):
            raise ValueError(f"tracer_fused: {name} must be a contiguous "
                             f"{psi.dtype} tensor {shape} on {psi.device}")
    periodic = cfg.sbc == -1
    if periodic and N < MIN_PERIODIC_N:
        raise ValueError(f"tracer_fused: the periodic kernel takes N >= "
                         f"{MIN_PERIODIC_N}, got {N}")
    lib = _lib(rows)
    if not 1 <= nptr <= lib.fused_tracer_max_nptr():
        raise ValueError(f"tracer_fused: nptr = {nptr}, the kernel takes 1 "
                         f"to {lib.fused_tracer_max_nptr()}")
    dtr = torch.empty(tracers.shape, dtype=psi.dtype, device=psi.device)
    fn = lib.fused_tracer_f32 if psi.dtype == torch.float32 \
        else lib.fused_tracer_f64
    dbl = ctypes.c_double * nptr
    relax = None if const.ptr_relax is None else const.ptr_relax.data_ptr()
    (gx, gy, _), _, smem = launch_geometry(N, nl, nptr, psi.element_size(),
                                           ny)
    src, tr_src = (psi_ext, tr_ext) if rows else (psi, tracers)
    with torch.cuda.device(psi.device):
        stream = torch.cuda.current_stream(psi.device).cuda_stream
        rc = fn(src.data_ptr(), tr_src.data_ptr(), relax, dtr.data_ptr(), N,
                nl, nptr, cfg.delta, dbl(*cfg.iPe[:nptr]),
                dbl(*cfg.ptr_ir[:nptr]), SY, gx, gy, smem, int(periodic),
                row0 if rows else 0, ny, int(rows), stream)
    if rc != 0:
        raise RuntimeError("fused_tracer launch failed: "
                           + lib.fused_tracer_error_string(rc).decode())
    launches += 1
    rows_launches += rows
    return dtr


def bound_work(cfg, const, itemsize: int, rows=None):
    """(bytes, operations) that the tendency needs at least: psi and the
    tracers read once (and the relaxation field where there is one), dtr
    written once; per cell and plane one Arakawa bracket (32), one
    Laplacian (6) and the diffusion and relaxation terms (6). With `rows`
    (row0, ny), the rows launch of that shard: ny rows of output and of
    the relaxation field, and of psi and the tracers one more row at each
    edge that is not a wall."""
    N, planes = cfg.N, cfg.nl * cfg.nptr
    ny, edges = N, 0
    if rows is not None:
        row0, ny = rows
        per = cfg.sbc == -1
        edges = int(per or row0 > 0) + int(per or row0 + ny < N)
    relax = planes if const.ptr_relax is not None else 0
    nbytes = ((cfg.nl + planes) * (ny + edges) + (relax + planes) * ny) \
        * N * itemsize
    return nbytes, 44 * planes * ny * N
