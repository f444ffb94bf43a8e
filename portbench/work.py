"""The yardstick's arithmetic: the card's published peaks, the least bytes
and operations of the tendency kernel K1, and the least work of a whole
msqg step, all worked out from shapes and never from the program.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W power
limit): 3.35 TB/s of HBM; 67 TFLOP/s in float32 and 34 TFLOP/s in float64
outside the tensor cores.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {4: 67e12, 8: 34e12}


def least_seconds(nbytes: float, nops: float, itemsize: int) -> float:
    """The roofline bound: the larger of bytes over the HBM rate and
    operations over the peak rate of the type."""
    return max(nbytes / HBM_BYTES_PER_S, nops / PEAK_OPS_PER_S[itemsize])


def k1_work(N: int, nl: int, itemsize: int, *, iRe: float, iRe4: float,
            pp=False, flsrv=False, need_q=False, stoch=False, topo=False,
            qforc=False, periodic=False) -> tuple[int, int]:
    """(bytes, operations) that the whole-domain tendency needs at least:
    every input field read once (psi, and where the options bring them pp,
    q, topo, qforc; the periodic run's pp with its ghost ring), dq written
    once, the y-profiles (wind and the nl - 1 stretching profiles) read and
    the (nl,) face-speed maxima written; the arithmetic counted per cell
    and layer from the formula. A frozen copy of the count that the
    program's K1 wrapper gives for its roofline bound."""
    cells = N * N * nl
    planes = nl * (2 if need_q else 1) * N * N + nl * N * N \
        + (N * N if topo else 0) + (nl * N * N if qforc else 0)
    if not pp:
        pp_cells = 0
    elif periodic:
        pp_cells = nl * (N + 2) * (N + 2)
    else:
        pp_cells = nl * N * N
    nbytes = (planes + pp_cells + N * nl + nl + (N if topo else 0)) \
        * itemsize
    gamma = 8 if nl > 1 else 0   # Gamma(.) at one cell
    jac = 32                     # one 12-point Arakawa bracket
    ops = 6 + 27 + 4             # zeta Laplacian, face speeds, wind/Ekman
    if nl > 1:
        ops += jac + 3 + 6       # self advection, beta, cascade weights
        if not need_q:
            ops += jac           # interface -J(psi_l, psi_l+1)
        if stoch:
            ops += 2             # -q / tr_stoch
        if pp:
            ops += 3 * jac + 3   # -J(pp, zeta) and the two cross terms
        if flsrv:
            ops += 6 + jac + 1   # zetap = lap pp, -J(psi, zetap)
    if iRe != 0.0 or iRe4 != 0.0:
        ops += 6                 # tmp = lap zeta
    if iRe != 0.0:
        ops += 2 + gamma
    if iRe4 != 0.0:
        ops += 6 + 2 + gamma     # lap tmp
    total = ops * cells
    if stoch:
        total -= jac * N * N     # no self advection in the top layer
    if topo:
        total += (jac + 2) * N * N
    if qforc:
        total += cells
    return nbytes, total


def transform_ops(N: int) -> float:
    """Operations of one real fast transform of length 2N + 2, the odd
    extension of a sine transform of N points: 2.5 M log2 M."""
    M = 2 * N + 2
    return 2.5 * M * math.log2(M)


def step_work(N: int, nl: int, itemsize: int, *, iRe: float,
              iRe4: float) -> tuple[float, float]:
    """(bytes, operations) that one predictor-corrector step of the msqg
    model needs at least, whatever solver or kernels compute it.

    Bytes: each field an update must read or write, counted once. The
    predictor reads q0 and writes psi1 and q1; the corrector reads q1 and
    q0 and writes psi2 and q: seven fields of nl N^2 values.
    Operations, per update: the tendency (K1's formula count), the axpy
    (2 a value), and the inversion as fast-transform work: the modal
    projections in and out (2 nl^2 a point each), a forward and an inverse
    2-D sine transform, each 2N transforms of length 2N + 2 a layer, and
    the division (1 a value)."""
    values = nl * N * N
    nbytes = 7 * values * itemsize
    _, k1_ops = k1_work(N, nl, itemsize, iRe=iRe, iRe4=iRe4)
    solve = 2 * (2 * nl * nl * N * N) + nl * 2 * (2 * N) * transform_ops(N) \
        + values
    per_update = k1_ops + 2 * values + solve
    return nbytes, 2 * per_update
