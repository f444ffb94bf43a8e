"""The block-Thomas y-sweeps of the y-profile direct solve: kernel KV of
the port.

`sweep(W, X, a) -> Psi` solves, for each of the Kx columns k independently,

    forward:   y_j   = W_j (X_j - a y_{j-1}),   j = 0 .. N-1, y_{-1} = 0
    backward:  psi_j = y_j - a W_j psi_{j+1},   j = N-1 .. 0, psi_N = 0

with W (nl, nl, N, Kx) the block inverses of `vary.build_spectral_vary`
and X, Psi (nl, N, Kx). It computes what the JAX package computes with two
`lax.scan`s over y (`msom_tpu/solvers/vary.py:270-291`, `fwd`/`bwd`); no
Pallas kernel is there, and no single PyTorch call computes it.

On a CUDA tensor it launches the hand-written Hopper kernels of
`csrc/vary_sweep.cu` (built at first use by `_build`, bound with ctypes;
the forward sweep, then the backward sweep, in one C call) or raises. On a
CPU tensor it runs the plain version, `sweep_reference`: the row loop of
torch ops that mirrors the JAX scans. `launches` counts the kernel's C
calls (one a solve).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from msom_tpu_torch import _build

SOURCE = "msom_tpu_torch/csrc/vary_sweep.cu"

launches = 0


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
                       ptr]
        fn.restype = i32
    lib.vary_sweep_max_nl.argtypes = []
    lib.vary_sweep_max_nl.restype = i32
    lib.vary_sweep_error_string.argtypes = [i32]
    lib.vary_sweep_error_string.restype = ctypes.c_char_p
    return lib


def sweep(W: torch.Tensor, X: torch.Tensor, a: float) -> torch.Tensor:
    """Psi (nl, N, Kx), a new tensor: the kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
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
    fn = lib.vary_sweep_f32 if X.dtype == torch.float32 \
        else lib.vary_sweep_f64
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = fn(W.data_ptr(), X.data_ptr(), Y.data_ptr(), Psi.data_ptr(),
                nl, N, K, float(a), stream)
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
