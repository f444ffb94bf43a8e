"""Fused multigrid hot loops: kernels K3 and K4 of the port.

`relax(da, res, prof, *, nrelax, d2, sign_x, sign_y) -> da` is nrelax full
red-black sweeps (red, then black) of the vertical-line smoother of the
layered multigrid, `rb_line_sweep` one of them (`relax(..., nrelax=1)`),
and `residual_norm(a, b, prof, *, delta, idh0, idh1, sign_x, sign_y) ->
(res, max|res|)` the fused residual res = b - lap(a) - Gamma(a) - lam*a with
its max norm. They compute what the JAX package's Pallas kernels compute
(`msom_tpu.solvers.pallas_mg`: `rb_line_sweep`/`_sweep_kernel` and
`residual_norm`/`_residual_kernel`) on a level whose coefficients vary in y
only: the coefficients come as (nl, n) y-profiles, taken as they are, and a
wall ghost is sign * (the current value of the edge cell), Dirichlet -1 /
Neumann +1, rebuilt for each colour. `periodic_x=True` is the Pallas
kernels' other mode: x wraps, and the ghost above row 0 is row 7 and the
one below row n - 1 row n - 8 (in a sweep as they were before it), the rows
the Pallas kernels' clamped 8-row halo blocks read; it needs an even
n >= 8.

On a CUDA tensor each launches its hand-written Hopper kernel
(`csrc/mg_sweep.cu`, `csrc/mg_residual.cu`, built at first use by `_build`,
bound with ctypes) or raises; every n >= 1 is taken. `relax` launches
ceil(nrelax / k) times, k the sweeps one launch takes
(`sweeps_per_launch`: every count where the level runs whole in one block,
the strip's KMAX = 4 elsewhere, 1 with periodic_x); K4 is one launch a
residual, its maximum included. On a CPU tensor each computes its plain
PyTorch version (`relax_reference`/`rb_line_sweep_reference`: two passes
of `relax_color` a sweep; `residual_norm_reference`: `residual_plain`),
which are also what a multigrid level without profiles runs on either
device (`solvers/mg.py`). `sweep_launches` and `residual_launches` count
kernel launches, `sweeps` the sweeps K3's launches ran, and
`sweep_launches_by_n` K3's launches by level width n.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import torch

from msom_tpu_torch import _build
from msom_tpu_torch.ops import tridiag
from msom_tpu_torch.ops.ghost import Ghosted, laplacian_g, neighbor_sum
from msom_tpu_torch.ops.stretch import stretch

SWEEP_SOURCE = "msom_tpu_torch/csrc/mg_sweep.cu"
RESIDUAL_SOURCE = "msom_tpu_torch/csrc/mg_residual.cu"

sweep_launches = 0
sweeps = 0
sweep_launches_by_n: collections.Counter[int] = collections.Counter()
residual_launches = 0


@dataclasses.dataclass(frozen=True)
class SweepProfiles:
    """(nl, n) y-profiles of one level's Thomas factors (`tridiag.factor`
    of the level's line system and its lower diagonal)."""
    t0: torch.Tensor
    cp: torch.Tensor
    im: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ResidualProfiles:
    """y-profiles of one level's operator: the stretching s (nl-1, n) and
    the Helmholtz term lam (nl, n), each optional."""
    s: torch.Tensor | None
    lam: torch.Tensor | None


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def relax_color(da_g: Ghosted, res: torch.Tensor, t0, cp, im, mask,
                d2: float) -> torch.Tensor:
    """One colour of the line relaxation: on the cells of `mask`, the exact
    solve of each column's vertical tridiagonal system with the horizontal
    neighbours frozen (poisson_layer.h:48-150, red-black instead of
    in-place Gauss-Seidel). t0/cp/im broadcast against (nl, n, n)."""
    return relax_color_sum(neighbor_sum(da_g), da_g.a, -d2 * res, t0, cp,
                           im, mask)


def relax_color_sum(nb: torch.Tensor, da: torch.Tensor, rhs0: torch.Tensor,
                    t0, cp, im, mask) -> torch.Tensor:
    """`relax_color` from the neighbour sum `nb` of the tile `da` (its
    ghosts' only use) and rhs0 = -d2 * res: the sharded multigrid's
    overlapped colour, which forms the sum while the ghosts are in
    flight."""
    x = tridiag.solve_factored(cp, im, t0, rhs0 + nb)
    return torch.where(mask, x, da)


def residual_plain(a_g: Ghosted, b: torch.Tensor, s, lam, delta: float,
                   idh0, idh1):
    """(res, max|res|), res = b - lap(a) - Gamma(a) - lam*a
    (poisson_layer.h:157-258); s and lam broadcast against the field."""
    return residual_lap(laplacian_g(a_g, delta), a_g.a, b, s, lam, idh0,
                        idh1)


def residual_lap(lap: torch.Tensor, a: torch.Tensor, b: torch.Tensor, s,
                 lam, idh0, idh1):
    """`residual_plain` from lap(a) (the sharded multigrid's overlapped
    residual forms it while the ghosts are in flight)."""
    res = b - lap
    if s is not None:
        res = res - stretch(a, s, idh0, idh1)
    if lam is not None:
        res = res - lam * a
    return res, res.abs().max()


def _pad_signed(a: torch.Tensor, sign_x: float, sign_y: float) -> Ghosted:
    """Ghost ring = sign * edge cell, x first, then y (the values of
    `ops.bc.pad` for Dirichlet -1 and Neumann +1)."""
    a = torch.cat([sign_x * a[..., :1], a, sign_x * a[..., -1:]], dim=-1)
    return Ghosted(torch.cat([sign_y * a[..., :1, :], a,
                              sign_y * a[..., -1:, :]], dim=-2))


def _pad_periodic_x(a: torch.Tensor, rows: torch.Tensor) -> Ghosted:
    """periodic_x's ghosts: x wraps; the ghost rows are rows[..., 0, :]
    above row 0 and rows[..., 1, :] below row n - 1 (their x ghosts, the
    corners, are never read)."""
    a = torch.cat([rows[..., :1, :], a, rows[..., 1:, :]], dim=-2)
    return Ghosted(torch.cat([a[..., -1:], a, a[..., :1]], dim=-1))


def _halo_rows(a: torch.Tensor) -> torch.Tensor:
    """(..., 2, n): rows 7 and n - 8 of a, the rows the Pallas kernels'
    clamped 8-row halo blocks give periodic_x as its y ghosts."""
    n = a.shape[-2]
    if n < 8 or n % 2:
        raise ValueError(f"periodic_x: n = {n}, it takes an even n >= 8")
    return torch.cat([a[..., 7:8, :], a[..., n - 8:n - 7, :]], dim=-2)


@functools.lru_cache(maxsize=64)
def checkerboard(ny: int, nx: int, device) -> torch.Tensor:
    """bool (ny, nx), True on the red cells: (row + column) even."""
    j = torch.arange(ny, device=device)[:, None]
    i = torch.arange(nx, device=device)[None, :]
    return ((j + i) % 2) == 0


def rb_line_sweep_reference(da: torch.Tensor, res: torch.Tensor,
                            prof: SweepProfiles, *, d2: float,
                            sign_x: float, sign_y: float,
                            periodic_x: bool = False) -> torch.Tensor:
    """The plain PyTorch version of one sweep: the red pass, then the black
    pass on its result, the ghosts rebuilt in between (periodic_x: the
    ghost rows of the sweep's input for both); on any device."""
    red = checkerboard(da.shape[-2], da.shape[-1], da.device)
    t0, cp, im = prof.t0[..., None], prof.cp[..., None], prof.im[..., None]
    rows = _halo_rows(da) if periodic_x else None
    for mask in (red, ~red):
        g = (_pad_periodic_x(da, rows) if periodic_x
             else _pad_signed(da, sign_x, sign_y))
        da = relax_color(g, res, t0, cp, im, mask, d2)
    return da


def relax_reference(da: torch.Tensor, res: torch.Tensor,
                    prof: SweepProfiles, *, nrelax: int, d2: float,
                    sign_x: float, sign_y: float,
                    periodic_x: bool = False) -> torch.Tensor:
    """nrelax plain sweeps (`rb_line_sweep_reference`); on any device."""
    for _ in range(nrelax):
        da = rb_line_sweep_reference(da, res, prof, d2=d2, sign_x=sign_x,
                                     sign_y=sign_y, periodic_x=periodic_x)
    return da


def residual_norm_reference(a: torch.Tensor, b: torch.Tensor,
                            prof: ResidualProfiles, *, delta: float, idh0,
                            idh1, sign_x: float, sign_y: float,
                            periodic_x: bool = False):
    """The plain PyTorch version of the residual; on any device."""
    s = None if prof.s is None else prof.s[..., None]
    lam = None if prof.lam is None else prof.lam[..., None]
    g = (_pad_periodic_x(a, _halo_rows(a)) if periodic_x
         else _pad_signed(a, sign_x, sign_y))
    return residual_plain(g, b, s, lam, delta, idh0, idh1)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

@functools.cache
def _sweep_lib():
    lib = _build.load("mg_sweep")
    ptr, dbl, i32 = ctypes.c_void_p, ctypes.c_double, ctypes.c_int
    for fn in (lib.mg_sweep_f32, lib.mg_sweep_f64):
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, dbl, dbl, dbl,
                       i32, i32, ptr]
        fn.restype = i32
    lib.mg_sweep_max_nl.argtypes = []
    lib.mg_sweep_max_nl.restype = i32
    lib.mg_sweep_per_launch.argtypes = [i32, i32, i32, i32]
    lib.mg_sweep_per_launch.restype = i32
    lib.mg_sweep_error_string.argtypes = [i32]
    lib.mg_sweep_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _residual_lib():
    lib = _build.load("mg_residual")
    ptr, dbl, i32 = ctypes.c_void_p, ctypes.c_double, ctypes.c_int
    for fn in (lib.mg_residual_f32, lib.mg_residual_f64):
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, dbl,
                       ctypes.POINTER(dbl), ctypes.POINTER(dbl), dbl, dbl,
                       i32, ptr]
        fn.restype = i32
    lib.mg_residual_max_nl.argtypes = []
    lib.mg_residual_max_nl.restype = i32
    lib.mg_residual_num_blocks.argtypes = [i32, i32, i32]
    lib.mg_residual_num_blocks.restype = i32
    lib.mg_residual_error_string.argtypes = [i32]
    lib.mg_residual_error_string.restype = ctypes.c_char_p
    return lib


def _check(what: str, ref: torch.Tensor, fields) -> None:
    """Raise on what the kernels do not take: `ref` an (nl, n, n) f32/f64
    CUDA tensor, every (name, tensor, shape) of `fields` contiguous, of
    that shape, on ref's device and of its type."""
    if ref.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {ref.device}")
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: dtype {ref.dtype} (float32 or float64)")
    if ref.ndim != 3 or ref.shape[-1] != ref.shape[-2]:
        raise ValueError(f"{what}: the field has shape {tuple(ref.shape)}, "
                         "the kernel takes (nl, n, n)")
    for name, t, shape in fields:
        if (tuple(t.shape) != shape or t.device != ref.device
                or t.dtype != ref.dtype or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"{ref.dtype} tensor {shape} on {ref.device}")


def sweeps_per_launch(n: int, nl: int, dtype: torch.dtype,
                      periodic_x: bool = False) -> int:
    """The most sweeps one K3 launch takes at (n, nl) in `dtype` (the C
    library's rule: 2**30 where the level runs whole in one block, KMAX
    for the strip, 1 with periodic_x)."""
    most = _sweep_lib().mg_sweep_per_launch(n, nl, torch.finfo(dtype).bits
                                            // 8, int(periodic_x))
    if most < 1:
        raise ValueError(f"periodic_x: n = {n}, it takes an even n >= 8")
    return most


def relax(da: torch.Tensor, res: torch.Tensor, prof: SweepProfiles, *,
          nrelax: int, d2: float, sign_x: float, sign_y: float,
          periodic_x: bool = False) -> torch.Tensor:
    """nrelax red-black sweeps of (nl, n, n) `da` against `res`: the kernel
    on a CUDA tensor, ceil(nrelax / sweeps_per_launch) launches, each into
    a new tensor; the plain version on a CPU tensor."""
    global sweep_launches, sweeps
    if da.device.type == "cpu":
        return relax_reference(da, res, prof, nrelax=nrelax, d2=d2,
                               sign_x=sign_x, sign_y=sign_y,
                               periodic_x=periodic_x)
    nl, n = da.shape[0], da.shape[-1]
    _check("relax", da, [
        ("da", da, (nl, n, n)), ("res", res, (nl, n, n)),
        ("prof.t0", prof.t0, (nl, n)), ("prof.cp", prof.cp, (nl, n)),
        ("prof.im", prof.im, (nl, n))])
    lib = _sweep_lib()
    if not 1 <= nl <= lib.mg_sweep_max_nl():
        raise ValueError(f"relax: nl = {nl}, the kernel takes 1 to "
                         f"{lib.mg_sweep_max_nl()}")
    most = sweeps_per_launch(n, nl, da.dtype, periodic_x)
    fn = lib.mg_sweep_f32 if da.dtype == torch.float32 else lib.mg_sweep_f64
    left = nrelax
    with torch.cuda.device(da.device):
        stream = torch.cuda.current_stream(da.device).cuda_stream
        while left > 0:
            k = min(left, most)
            out = torch.empty_like(da)
            rc = fn(da.data_ptr(), res.data_ptr(), prof.t0.data_ptr(),
                    prof.cp.data_ptr(), prof.im.data_ptr(), out.data_ptr(),
                    n, nl, float(d2), float(sign_x), float(sign_y), k,
                    int(periodic_x), stream)
            if rc != 0:
                raise RuntimeError("mg_sweep launch failed: "
                                   + lib.mg_sweep_error_string(rc).decode())
            sweep_launches += 1
            sweeps += k
            sweep_launches_by_n[n] += 1
            da, left = out, left - k
    return da


def rb_line_sweep(da: torch.Tensor, res: torch.Tensor, prof: SweepProfiles,
                  *, d2: float, sign_x: float, sign_y: float,
                  periodic_x: bool = False) -> torch.Tensor:
    """One red-black sweep: `relax(..., nrelax=1)`. Returns a new tensor."""
    return relax(da, res, prof, nrelax=1, d2=d2, sign_x=sign_x,
                 sign_y=sign_y, periodic_x=periodic_x)


@functools.cache
def _ticket(device: torch.device) -> torch.Tensor:
    """K4's ticket on `device`: one unsigned int, 0 between launches (the
    last block of a launch sets it back)."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def residual_norm(a: torch.Tensor, b: torch.Tensor, prof: ResidualProfiles,
                  *, delta: float, idh0, idh1, sign_x: float, sign_y: float,
                  periodic_x: bool = False):
    """(res, max|res|) of (nl, n, n) `a` against `b`, the maximum a 0-d
    tensor: the kernel on a CUDA tensor (one launch, its last block
    reduces the blocks' maxima; a NaN residual gives a NaN maximum, as
    `Tensor.max` does), the plain version on a CPU tensor."""
    global residual_launches
    if a.device.type == "cpu":
        return residual_norm_reference(a, b, prof, delta=delta, idh0=idh0,
                                       idh1=idh1, sign_x=sign_x,
                                       sign_y=sign_y, periodic_x=periodic_x)
    nl, n = a.shape[0], a.shape[-1]
    fields = [("a", a, (nl, n, n)), ("b", b, (nl, n, n))]
    if prof.s is not None:
        fields.append(("prof.s", prof.s, (nl - 1, n)))
    if prof.lam is not None:
        fields.append(("prof.lam", prof.lam, (nl, n)))
    _check("residual_norm", a, fields)
    lib = _residual_lib()
    if not 1 <= nl <= lib.mg_residual_max_nl():
        raise ValueError(f"residual_norm: nl = {nl}, the kernel takes 1 to "
                         f"{lib.mg_residual_max_nl()}")
    if len(idh0) != nl or len(idh1) != nl:
        raise ValueError(f"residual_norm: idh0 and idh1 must have {nl} "
                         "entries")
    if periodic_x and (n < 8 or n % 2):
        raise ValueError(f"periodic_x: n = {n}, it takes an even n >= 8")
    res = torch.empty_like(a)
    mx = torch.empty((), dtype=a.dtype, device=a.device)
    partial = torch.empty(
        lib.mg_residual_num_blocks(n, nl, a.element_size()), dtype=a.dtype,
        device=a.device)
    fn = lib.mg_residual_f32 if a.dtype == torch.float32 \
        else lib.mg_residual_f64
    dbl = ctypes.c_double * nl
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(),
                None if prof.s is None else prof.s.data_ptr(),
                None if prof.lam is None else prof.lam.data_ptr(),
                res.data_ptr(), partial.data_ptr(),
                _ticket(a.device).data_ptr(), mx.data_ptr(), n, nl,
                float(delta), dbl(*(float(v) for v in idh0)),
                dbl(*(float(v) for v in idh1)), float(sign_x), float(sign_y),
                int(periodic_x), stream)
    if rc != 0:
        raise RuntimeError("mg_residual launch failed: "
                           + lib.mg_residual_error_string(rc).decode())
    residual_launches += 1
    return res, mx


def sweep_bound_work(nl: int, n: int, itemsize: int, nsweep: int = 1):
    """(bytes, operations) a launch of nsweep sweeps needs at least: da and
    res read and da written once, the three profiles read; per cell, layer
    and sweep the neighbour sum and right-hand side (5) and the two Thomas
    recurrences (5)."""
    return ((3 * nl * n * n + 3 * nl * n) * itemsize,
            10 * nl * n * n * nsweep)


def residual_bound_work(nl: int, n: int, itemsize: int, has_s: bool,
                        has_lam: bool):
    """(bytes, operations) one residual needs at least: a and b read and
    res written once, the profiles read; per cell and layer the Laplacian
    and the subtraction (7), the norm (2), the stretching (6) and the
    Helmholtz term (2) where the level has them."""
    nprof = (nl - 1 if has_s else 0) + (nl if has_lam else 0)
    ops = 9 + (6 if has_s else 0) + (2 if has_lam else 0)
    return (3 * nl * n * n + nprof * n) * itemsize, ops * nl * n * n
