"""Fused passive-tracer tendency: kernel K2 of the port.

`tracer_fused(cfg, const, psi, tracers) -> dtr` computes what the JAX
package's Pallas kernel (`msom_tpu.models.pallas_rhs.tracer_fused`,
`_tracer_kernel`) computes: for the (nl, nptr, N, N) tracers,
dtr = -J(psi_l, c) + iPe_j lap(c) + ir_j (relax - c) (ptr_rhs,
msqg/qg.h:573-588), with Neumann tracer ghosts and Dirichlet psi ghosts on
a walled domain, and everything wrapped on the doubly periodic one
(sbc = -1).

On a CUDA tensor it launches the hand-written Hopper kernel in
`csrc/fused_tracer.cu`, a strip that marches down y on the grid and
shared memory that `launch_geometry` gives it (built at first use by
`_build`, bound with ctypes), or raises. On a CPU tensor it computes the
plain PyTorch version, `tracer_fused_reference`, the tracer block of
`qg.rhs`. `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from msom_tpu_torch import _build
from msom_tpu_torch.ops.ghost import ghosted

SOURCE = "msom_tpu_torch/csrc/fused_tracer.cu"

# The strip of csrc/fused_tracer.cu: TX columns (one thread each) by SY rows
# of one layer, and a ring of RING rows of TX + 2 XH columns for psi_l and
# each tracer of the layer in shared memory. SY is chosen here; TX, RING and
# XH are the kernel's, whose launch refuses a geometry that does not fit
# them.
TX, SY, RING, XH = 128, 32, 8, 4
MIN_PERIODIC_N = 4           # the periodic halo wraps once

launches = 0


def strips(n: int, width: int) -> list[tuple[int, int]]:
    """The [start, stop) ranges of the strips that cover 0 .. n - 1: all
    `width` long but the last, which keeps the remainder."""
    return [(a, min(a + width, n)) for a in range(0, n, width)]


def launch_geometry(N: int, nl: int, nptr: int, itemsize: int):
    """(grid, threads a block, dynamic shared-memory bytes) of the kernel's
    launch, strips of SY rows, for N^2 planes, nl layers and nptr tracers
    of `itemsize` bytes."""
    grid = (len(strips(N, TX)), len(strips(N, SY)), nl)
    return grid, TX, RING * (1 + nptr) * (TX + 2 * XH) * itemsize


def tracer_fused_reference(cfg, const, psi: torch.Tensor,
                           tracers: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version (qg.tracer_rhs), on any device."""
    from msom_tpu_torch.models import qg
    return qg.tracer_rhs(cfg, const, ghosted(psi, qg._bc_psi(cfg)), tracers)


@functools.cache
def _lib():
    """The built library with its C signatures declared."""
    lib = _build.load("fused_tracer")
    ptr = ctypes.c_void_p
    dbl = ctypes.POINTER(ctypes.c_double)
    for fn in (lib.fused_tracer_f32, lib.fused_tracer_f64):
        fn.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_double, dbl, dbl, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
    lib.fused_tracer_max_nptr.argtypes = []
    lib.fused_tracer_max_nptr.restype = ctypes.c_int
    lib.fused_tracer_error_string.argtypes = [ctypes.c_int]
    lib.fused_tracer_error_string.restype = ctypes.c_char_p
    return lib


def tracer_fused(cfg, const, psi: torch.Tensor,
                 tracers: torch.Tensor) -> torch.Tensor:
    """dtr (nl, nptr, N, N): the kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    global launches
    if psi.device.type == "cpu":
        return tracer_fused_reference(cfg, const, psi, tracers)
    if psi.device.type != "cuda":
        raise ValueError(f"tracer_fused: unsupported device {psi.device}")
    nl, N, nptr = cfg.nl, cfg.N, cfg.nptr
    if psi.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"tracer_fused: dtype {psi.dtype} (float32 or "
                        "float64)")
    fields = [("psi", psi, (nl, N, N)), ("tracers", tracers, (nl, nptr, N, N))]
    if const.ptr_relax is not None:
        fields.append(("const.ptr_relax", const.ptr_relax, (nl, nptr, N, N)))
    for name, t, shape in fields:
        if (tuple(t.shape) != shape or t.device != psi.device
                or t.dtype != psi.dtype or not t.is_contiguous()):
            raise ValueError(f"tracer_fused: {name} must be a contiguous "
                             f"{psi.dtype} tensor {shape} on {psi.device}")
    periodic = cfg.sbc == -1
    if periodic and N < MIN_PERIODIC_N:
        raise ValueError(f"tracer_fused: the periodic kernel takes N >= "
                         f"{MIN_PERIODIC_N}, got {N}")
    lib = _lib()
    if not 1 <= nptr <= lib.fused_tracer_max_nptr():
        raise ValueError(f"tracer_fused: nptr = {nptr}, the kernel takes 1 "
                         f"to {lib.fused_tracer_max_nptr()}")
    dtr = torch.empty_like(tracers)
    fn = lib.fused_tracer_f32 if psi.dtype == torch.float32 \
        else lib.fused_tracer_f64
    dbl = ctypes.c_double * nptr
    relax = None if const.ptr_relax is None else const.ptr_relax.data_ptr()
    (gx, gy, _), _, smem = launch_geometry(N, nl, nptr, psi.element_size())
    with torch.cuda.device(psi.device):
        stream = torch.cuda.current_stream(psi.device).cuda_stream
        rc = fn(psi.data_ptr(), tracers.data_ptr(), relax, dtr.data_ptr(), N,
                nl, nptr, cfg.delta, dbl(*cfg.iPe[:nptr]),
                dbl(*cfg.ptr_ir[:nptr]), SY, gx, gy, smem, int(periodic),
                stream)
    if rc != 0:
        raise RuntimeError("fused_tracer launch failed: "
                           + lib.fused_tracer_error_string(rc).decode())
    launches += 1
    return dtr


def bound_work(cfg, const, itemsize: int):
    """(bytes, operations) that the tendency needs at least: psi and the
    tracers read once (and the relaxation field where there is one), dtr
    written once; per cell and plane one Arakawa bracket (32), one
    Laplacian (6) and the diffusion and relaxation terms (6)."""
    planes = cfg.nl * cfg.nptr
    nread = cfg.nl + planes * (2 if const.ptr_relax is not None else 1)
    cells = cfg.N * cfg.N
    return (nread + planes) * cells * itemsize, 44 * planes * cells
