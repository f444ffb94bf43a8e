"""The block-Thomas y-sweeps of the y-profile direct solve: kernel KV of
the port.

`sweep(W, X, a) -> Psi` solves, for each of the Kx columns k independently,

    forward:   y_j   = W_j (X_j - a y_{j-1}),   j = 0 .. N-1, y_{-1} = 0
    backward:  psi_j = y_j - a W_j psi_{j+1},   j = N-1 .. 0, psi_N = 0

with W (nl, nl, N, Kx) the block inverses of `vary.build_spectral_vary`
and X, Psi (nl, N, Kx). It computes what the JAX package computes with two
`lax.scan`s over y (`msom_tpu/solvers/vary.py:270-291`, `fwd`/`bwd`); no
Pallas kernel is there, and no single PyTorch call computes it.

On a CUDA tensor it launches the hand-written Hopper kernel of
`csrc/vary_sweep.cu` (built at first use by `_build`, bound with ctypes;
both sweeps in one launch) or raises. On a CPU tensor it runs the plain
version, `sweep_reference`: the row loop of torch ops that mirrors the JAX
scans. `launches` counts the kernel's C calls (one a solve).

`geometry` decides the launch: `cols` columns a block, `lanes` threads a
column (the power of two at least nl; lane i owns row i of the block
product), a ring of `stages` stages of `rows` rows in shared memory, TMA
boxes where the global strides are 16-byte aligned, else element copies.
The C launch refuses a geometry that does not fit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from msom_tpu_torch import _build

SOURCE = "msom_tpu_torch/csrc/vary_sweep.cu"

launches = 0

MAX_ROWS = 15              # csrc's MAXR: most rows of a stage
STAGE_BYTES = 16 * 1024    # csrc's STAGE_BYTES: most bytes of a stage
REG_WORDS = 80             # csrc's REG_WORDS: registers a stage preloads
RING_BYTES = 64 * 1024     # bytes of the ring (Little's law at 3.35 TB/s)
MAX_STAGES = 32            # csrc's MAXSTAGES
MAX_SMEM = 232448          # dynamic shared memory a block may use


@dataclasses.dataclass(frozen=True)
class Geometry:
    """A launch of KV: `grid` blocks of `cols` columns, `lanes` threads a
    column and one producer warp (`threads`), a ring of `stages` stages of
    `rows` rows (`smem` bytes of dynamic shared memory), fed by TMA boxes
    (`tma`) or element copies."""
    cols: int
    lanes: int
    rows: int
    stages: int
    tma: bool
    grid: int
    threads: int
    smem: int


def lanes_for(nl: int) -> int:
    """Threads a column: the power of two at least nl (csrc's
    `lanes_for`)."""
    return 2 if nl <= 2 else (4 if nl <= 4 else 8)


def cols_for(nl: int) -> int:
    """Columns a block (csrc's `cols_for`): 8, 16 where a column has two
    lanes, so that the consumers are whole warps; 256 or 128 blocks at
    Kx = 2048."""
    return 16 if lanes_for(nl) == 2 else 8


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def stage_bytes(nl: int, itemsize: int, cols: int, rows: int) -> int:
    """Bytes of a stage, as csrc's `stage_bytes`: the W box and the
    right-hand side box, each padded to 128 bytes."""
    return (_align128(rows * cols * nl * nl * itemsize)
            + _align128(rows * cols * nl * itemsize))


def smem_bytes(nl: int, itemsize: int, cols: int, rows: int,
               stages: int) -> int:
    """Dynamic shared memory of a launch, as csrc's `smem_bytes`: alignment
    slack, the barriers and the ring."""
    return (128 + _align128(8 * (2 * stages + 1))
            + stages * stage_bytes(nl, itemsize, cols, rows))


def rows_for(nl: int, itemsize: int) -> int:
    """Rows of a stage, a compile-time constant of the kernel (csrc's
    `rows_for`): the most, odd and at most MAX_ROWS, whose stage of
    `cols_for` columns fits STAGE_BYTES and whose preloaded values fit
    REG_WORDS registers (odd: the lanes' W loads then hit different
    shared-memory banks)."""
    r = MAX_ROWS
    while r > 1 and (r * cols_for(nl) * (nl * nl + nl) * itemsize
                     > STAGE_BYTES or r * (nl + 1) * itemsize
                     > 4 * REG_WORDS):
        r -= 2
    return r


def geometry(nl: int, N: int, K: int, itemsize: int, *,
             aligned: bool = True) -> Geometry:
    """The launch for (nl, N, K) planes of `itemsize` bytes: blocks of
    `cols_for` columns, `lanes_for` lanes a column, stages of `rows_for`
    rows, as many as fit RING_BYTES (at least one, at most the two
    sweeps' stages, within MAX_SMEM), TMA where the global strides and
    the pointers (`aligned`) are 16-byte aligned."""
    cols, lanes, rows = cols_for(nl), lanes_for(nl), rows_for(nl, itemsize)
    stages = max(1, min(MAX_STAGES, 2 * -(-N // rows),
                        RING_BYTES // stage_bytes(nl, itemsize, cols, rows)))
    while stages > 1 and smem_bytes(nl, itemsize, cols, rows,
                                    stages) > MAX_SMEM:
        stages -= 1
    tma = aligned and (K * itemsize) % 16 == 0 and (cols * itemsize) % 16 == 0
    return Geometry(cols=cols, lanes=lanes, rows=rows, stages=stages,
                    tma=tma, grid=-(-K // cols), threads=cols * lanes + 32,
                    smem=smem_bytes(nl, itemsize, cols, rows, stages))


def sweep_reference(W: torch.Tensor, X: torch.Tensor,
                    a: float) -> torch.Tensor:
    """The plain PyTorch version, on any device: the forward and backward
    row loops (2N steps of a few torch ops each)."""
    N = X.shape[1]
    Y = torch.empty_like(X)
    carry = torch.zeros_like(X[:, 0])
    for j in range(N):
        carry = torch.einsum("abk,bk->ak", W[:, :, j], X[:, j] - a * carry)
        Y[:, j] = carry
    Psi = torch.empty_like(X)
    carry = torch.zeros_like(X[:, 0])
    for j in range(N - 1, -1, -1):
        carry = Y[:, j] - a * torch.einsum("abk,bk->ak", W[:, :, j], carry)
        Psi[:, j] = carry
    return Psi


@functools.cache
def _lib():
    lib = _build.load("vary_sweep")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.vary_sweep_f32, lib.vary_sweep_f64):
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, ctypes.c_double,
                       i32, i32, i32, i32, i32, i32, ptr]
        fn.restype = i32
    lib.vary_sweep_max_nl.argtypes = []
    lib.vary_sweep_max_nl.restype = i32
    lib.vary_sweep_error_string.argtypes = [i32]
    lib.vary_sweep_error_string.restype = ctypes.c_char_p
    return lib


def sweep(W: torch.Tensor, X: torch.Tensor, a: float,
          geom: Geometry | None = None) -> torch.Tensor:
    """Psi (nl, N, Kx), a new tensor: the kernel on a CUDA tensor (launched
    with `geom`, by default `geometry`'s), the plain version on a CPU
    tensor."""
    global launches
    if X.device.type == "cpu":
        return sweep_reference(W, X, a)
    if X.device.type != "cuda":
        raise ValueError(f"sweep: unsupported device {X.device}")
    if X.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sweep: dtype {X.dtype} (float32 or float64)")
    if X.ndim != 3:
        raise ValueError(f"sweep: X has shape {tuple(X.shape)}, the kernel "
                         "takes (nl, N, Kx)")
    nl, N, K = X.shape
    for name, t, shape in (("W", W, (nl, nl, N, K)), ("X", X, (nl, N, K))):
        if (tuple(t.shape) != shape or t.device != X.device
                or t.dtype != X.dtype or not t.is_contiguous()):
            raise ValueError(f"sweep: {name} must be a contiguous {X.dtype} "
                             f"tensor {shape} on {X.device}")
    lib = _lib()
    if not 2 <= nl <= lib.vary_sweep_max_nl():
        raise ValueError(f"sweep: nl = {nl}, the kernel takes 2 to "
                         f"{lib.vary_sweep_max_nl()}")
    Y = torch.empty_like(X)
    Psi = torch.empty_like(X)
    if geom is None:
        aligned = all(t.data_ptr() % 16 == 0 for t in (W, X, Y))
        geom = geometry(nl, N, K, X.element_size(), aligned=aligned)
    fn = lib.vary_sweep_f32 if X.dtype == torch.float32 \
        else lib.vary_sweep_f64
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = fn(W.data_ptr(), X.data_ptr(), Y.data_ptr(), Psi.data_ptr(),
                nl, N, K, float(a), geom.cols, geom.lanes, geom.rows,
                geom.stages, int(geom.tma), geom.smem, stream)
    if rc != 0:
        raise RuntimeError("vary_sweep launch failed: "
                           + lib.vary_sweep_error_string(rc).decode())
    launches += 1
    return Psi


def bound_work(nl: int, N: int, K: int, itemsize: int):
    """(bytes, operations) a solve's sweeps need at least: W read by each
    sweep (it is larger than the L2 cache at the paths' sizes), X read, Y
    written and read back, Psi written; per row, column and sweep the
    block product (2 nl^2) and the axpy (2 nl)."""
    nbytes = (2 * nl * nl + 4 * nl) * N * K * itemsize
    return nbytes, 2 * (2 * nl * nl + 2 * nl) * N * K
