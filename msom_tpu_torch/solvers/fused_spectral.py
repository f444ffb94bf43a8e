"""Basis-matmul spectral solve in modal space: kernel K7 of the port.

`fused_mm_solve(S, inv_den, qm) -> psi_m` computes what the JAX package's
Pallas kernel (`msom_tpu.solvers.pallas_spectral.fused_mm_solve`) computes:
psi_m[l] = S^T((S qm[l] S^T) * inv_den[l]) S for every modal layer, S the
(N, N) orthonormal DST-II basis. Gate, as the TPU kernel's: float32 (and
float64, for a rounding-free check), 128 <= N <= 1024, N % 128 == 0;
anything else raises ValueError.

On a CUDA tensor the four products run in the hand-written FP32 tiled GEMM
kernel of `csrc/fused_spectral.cu` (built at first use by `_build`, bound
with ctypes), one launch a product over all layers, the transposes taken in
its index maps and the inv_den scale fused into the second product's
epilogue; or it raises. On a CPU tensor it computes the plain PyTorch
version, `spectral._mm_solve`. `launches` counts kernel launches, four a
solve.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from msom_tpu_torch import _build

SOURCE = "msom_tpu_torch/csrc/fused_spectral.cu"
N_MIN, N_MAX, N_STEP = 128, 1024, 128

launches = 0


def check_gate(dtype: torch.dtype, N: int) -> None:
    """Raise ValueError for a size or type the fused solve does not take."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"fused_mm_solve: dtype {dtype} (float32 or "
                         "float64)")
    if not N_MIN <= N <= N_MAX or N % N_STEP:
        raise ValueError(f"fused_mm_solve: N = {N}, the fused solve takes "
                         f"{N_MIN} <= N <= {N_MAX} with N % {N_STEP} == 0")


def fused_mm_solve_reference(S: torch.Tensor, inv_den: torch.Tensor,
                             qm: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version (spectral._mm_solve), on any device."""
    from msom_tpu_torch.solvers import spectral
    return spectral._mm_solve(S, inv_den, qm)


@functools.cache
def _lib():
    """The built library with its C signatures declared."""
    lib = _build.load("fused_spectral")
    ptr, ll = ctypes.c_void_p, ctypes.c_longlong
    for fn in (lib.fused_spectral_gemm_f32, lib.fused_spectral_gemm_f64):
        fn.argtypes = [ptr, ll, ctypes.c_int, ptr, ll, ctypes.c_int, ptr, ptr,
                       ctypes.c_int, ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
    lib.fused_spectral_error_string.argtypes = [ctypes.c_int]
    lib.fused_spectral_error_string.restype = ctypes.c_char_p
    return lib


def fused_mm_solve(S: torch.Tensor, inv_den: torch.Tensor,
                   qm: torch.Tensor) -> torch.Tensor:
    """psi_m (nl, N, N): the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    global launches
    if qm.ndim != 3 or qm.shape[-1] != qm.shape[-2]:
        raise ValueError(f"fused_mm_solve: qm must be (nl, N, N), got "
                         f"{tuple(qm.shape)}")
    nl, N, _ = qm.shape
    check_gate(qm.dtype, N)
    if qm.device.type == "cpu":
        return fused_mm_solve_reference(S, inv_den, qm)
    if qm.device.type != "cuda":
        raise ValueError(f"fused_mm_solve: unsupported device {qm.device}")
    for name, t, shape in (("S", S, (N, N)), ("inv_den", inv_den, (nl, N, N)),
                           ("qm", qm, (nl, N, N))):
        if (tuple(t.shape) != shape or t.device != qm.device
                or t.dtype != qm.dtype or not t.is_contiguous()):
            raise ValueError(f"fused_mm_solve: {name} must be a contiguous "
                             f"{qm.dtype} tensor {shape} on {qm.device}")
    lib = _lib()
    fn = lib.fused_spectral_gemm_f32 if qm.dtype == torch.float32 \
        else lib.fused_spectral_gemm_f64
    t1, t2, out = (torch.empty_like(qm) for _ in range(3))
    NN = N * N
    # (A, its layer stride, transposed?, B, stride, transposed?, scale, C)
    chain = [(qm, NN, 0, S, 0, 1, None, t1),        # q S^T
             (S, 0, 0, t1, NN, 0, inv_den, t2),     # (S .) * inv_den
             (S, 0, 1, t2, NN, 0, None, t1),        # S^T .
             (t1, NN, 0, S, 0, 0, None, out)]       # . S
    with torch.cuda.device(qm.device):
        stream = torch.cuda.current_stream(qm.device).cuda_stream
        for A, sa, ta, B, sb, tb, D, C in chain:
            rc = fn(A.data_ptr(), sa, ta, B.data_ptr(), sb, tb,
                    None if D is None else D.data_ptr(), C.data_ptr(), N, nl,
                    stream)
            if rc != 0:
                raise RuntimeError(
                    "fused_spectral launch failed: "
                    + lib.fused_spectral_error_string(rc).decode())
            launches += 1
    return out


def bound_work(N: int, nl: int, itemsize: int):
    """(bytes, operations) that a solve needs at least: S, qm and inv_den
    read once and psi_m written once; four N x N products (2 N^3 each) and
    the scale, per layer."""
    return ((1 + 3 * nl) * N * N * itemsize,
            nl * (4 * 2 * N ** 3 + N * N))
