"""Fused masked vertex sweep: kernel K6 of the port.

`vrb_sweep(da, res, lvl) -> da` is one full red-black sweep (red, then
black) of the vertex multigrid's masked vertical-line smoother
(`solvers.vmg.relax_v`, qg-node/qg_baroclinic_ms.h:228-293): on the nodes of
the colour ((row + column) & 1), rhs = (-Delta^2 res + E + W + N + S) * mask
with the neighbour sum zero on the boundary ring, the column's
nl-tridiagonal solved by Thomas with the level's full 2-D factors t0, cp, im
(they carry the mask and an x-varying S2), the solution times the mask; the
other colour keeps its value. It computes what the JAX package's Pallas
kernel (`msom_tpu.solvers.pallas_vmg.vrb_sweep`, `_vsweep_kernel`)
computes.

On a CUDA tensor it launches the hand-written Hopper kernel
(`csrc/vmg_sweep.cu`, built at first use by `_build`, bound with ctypes) or
raises; every n >= 3 and 1 <= nl <= 8 are taken, with partial tiles. On a
CPU tensor it computes the plain PyTorch version `vrb_sweep_reference`: two
passes of `one_color`, relax_v's body. `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from msom_tpu_torch import _build
from msom_tpu_torch.ops import tridiag

SOURCE = "msom_tpu_torch/csrc/vmg_sweep.cu"

launches = 0


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def one_color(da: torch.Tensor, res: torch.Tensor, lvl, color_mask,
              d2: float) -> torch.Tensor:
    """One colour of relax_v: on the nodes of `color_mask` (bool (n, n)),
    the exact solve of each column's vertical tridiagonal system with the
    horizontal neighbours frozen, masked; the other nodes keep their
    value. The neighbour sum is zero on the boundary ring."""
    nbsum = (da[..., 1:-1, 2:] + da[..., 1:-1, :-2]
             + da[..., 2:, 1:-1] + da[..., :-2, 1:-1])
    rhs = (-d2 * res + F.pad(nbsum, (1, 1, 1, 1))) * lvl.mask
    x = tridiag.solve_factored(lvl.cp, lvl.im, lvl.t0, rhs)
    return torch.where(color_mask, x * lvl.mask, da)


def vrb_sweep_reference(da: torch.Tensor, res: torch.Tensor,
                        lvl) -> torch.Tensor:
    """The plain version of one sweep, the red pass then the black pass on
    its result (relax_v's body); on any device."""
    d2 = lvl.delta * lvl.delta
    for color_mask in (lvl.red, ~lvl.red):
        da = one_color(da, res, lvl, color_mask, d2)
    return da


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

@functools.cache
def _kernel():
    """({dtype: the C launcher}, the largest nl, the error-string lookup),
    looked up once."""
    lib = _build.load("vmg_sweep")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.vmg_sweep_f32, lib.vmg_sweep_f64):
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32,
                       ctypes.c_double, ptr]
        fn.restype = i32
    lib.vmg_sweep_max_nl.argtypes = []
    lib.vmg_sweep_max_nl.restype = i32
    lib.vmg_sweep_error_string.argtypes = [i32]
    lib.vmg_sweep_error_string.restype = ctypes.c_char_p
    fns = {torch.float32: lib.vmg_sweep_f32, torch.float64: lib.vmg_sweep_f64}
    return fns, lib.vmg_sweep_max_nl(), lib.vmg_sweep_error_string


def check_level(lvl) -> None:
    """Raise unless the level's t0, cp, im are contiguous (nl, n, n) fields
    and its mask a contiguous (n, n) field, n >= 3, all of one dtype on one
    device: the layout the kernel reads. A level is checked once, when it
    is made (vmg.VLevel), so a launch checks only its own arguments."""
    mask = lvl.mask
    n = mask.shape[-1]
    if mask.ndim != 2 or mask.shape[0] != n or n < 3 \
            or not mask.is_contiguous():
        raise ValueError(f"VLevel: the mask has shape {tuple(mask.shape)}, "
                         "a level takes a contiguous (n, n) mask, n >= 3")
    nl = lvl.t0.shape[0]
    for name in ("t0", "cp", "im"):
        t = getattr(lvl, name)
        if (tuple(t.shape) != (nl, n, n) or t.dtype != mask.dtype
                or t.device != mask.device or not t.is_contiguous()):
            raise ValueError(f"VLevel: {name} must be a contiguous "
                             f"{mask.dtype} tensor {(nl, n, n)} on "
                             f"{mask.device}")


def vrb_sweep(da: torch.Tensor, res: torch.Tensor, lvl) -> torch.Tensor:
    """One red-black sweep of (nl, n, n) `da` against `res` on the level
    `lvl` (a vmg.VLevel, checked when it was made): the kernel on a CUDA
    tensor, the plain version on a CPU tensor. Returns a new tensor."""
    global launches
    if da.device.type == "cpu":
        return vrb_sweep_reference(da, res, lvl)
    if da.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"vrb_sweep: dtype {da.dtype} (float32 or float64)")
    shape = lvl.t0.shape
    if (da.shape != shape or da.dtype != lvl.mask.dtype
            or da.device != lvl.mask.device):
        raise ValueError(f"vrb_sweep: the level takes {lvl.mask.dtype} "
                         f"{tuple(shape)} on {lvl.mask.device}, da is "
                         f"{da.dtype} {tuple(da.shape)} on {da.device}")
    for name, t in (("da", da), ("res", res)):
        if (t.shape != shape or t.dtype != da.dtype or t.device != da.device
                or not t.is_contiguous()):
            raise ValueError(f"vrb_sweep: {name} must be a contiguous "
                             f"{da.dtype} tensor {tuple(shape)} on "
                             f"{da.device}")
    fns, max_nl, error_string = _kernel()
    nl, n = shape[0], shape[-1]
    if not 1 <= nl <= max_nl:
        raise ValueError(f"vrb_sweep: nl = {nl}, the kernel takes 1 to "
                         f"{max_nl}")
    out = torch.empty_like(da)
    with torch.cuda.device(da.device):
        stream = torch.cuda.current_stream(da.device).cuda_stream
        rc = fns[da.dtype](da.data_ptr(), res.data_ptr(), lvl.t0.data_ptr(),
                           lvl.cp.data_ptr(), lvl.im.data_ptr(),
                           lvl.mask.data_ptr(), out.data_ptr(), n, nl,
                           float(lvl.delta * lvl.delta), stream)
    if rc != 0:
        raise RuntimeError("vmg_sweep launch failed: "
                           + error_string(rc).decode())
    launches += 1
    return out


def bound_work(nl: int, n: int, itemsize: int):
    """(bytes, operations) one sweep needs at least: da, res, t0, cp and im
    read, the mask read and da written once; per node and layer the
    neighbour sum and right-hand side (6), the two Thomas recurrences (5)
    and the mask (1)."""
    return (6 * nl * n * n + n * n) * itemsize, 12 * nl * n * n
