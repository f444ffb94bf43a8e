"""Batched tridiagonal (Thomas) solves over the layer axis (the port of
`msom_tpu.ops.tridiag`).

The vertical dimension is small and static, so the elimination is unrolled
over layers and every step is an elementwise op over all (ny, nx) cells at
once. The coefficients may be full (nl, ny, nx) fields or anything that
broadcasts against them, e.g. (nl, ny, 1) y-profiles. `thomas_scan` is the
same elimination along a long axis 0 as a loop (mspg's 4N-point perimeter
system of the circulation BC, whose inverse it forms once at set-up).
"""

from __future__ import annotations

import torch


def thomas(t0: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor,
           rhs: torch.Tensor) -> torch.Tensor:
    """Solve t0[l]*x[l-1] + t1[l]*x[l] + t2[l]*x[l+1] = rhs[l] per cell;
    all inputs (nl, ...)."""
    cp, im = factor(t0, t1, t2)
    return solve_factored(cp, im, t0, rhs)


def thomas_scan(t0: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor,
                rhs: torch.Tensor) -> torch.Tensor:
    """The Thomas solve of `thomas` along a long axis 0 (the JAX package's
    lax.scan form): a forward sweep for (cp, dp), then back substitution.
    The coefficients are (n,) or broadcast against rhs (n, ...)."""
    cp = dp = torch.zeros_like(rhs[0])
    cps, dps = [], []
    for a, b, c, d in zip(t0, t1, t2, rhs):
        m = b - a * cp
        cp = c / m
        dp = (d - a * dp) / m
        cps.append(cp)
        dps.append(dp)
    x = torch.zeros_like(rhs[0])
    xs = []
    for cp, dp in zip(reversed(cps), reversed(dps)):
        x = dp - cp * x
        xs.append(x)
    xs.reverse()
    return torch.stack(xs)


def factor(t0: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor):
    """The Thomas elimination factors (cp, inv_m), so that repeated solves
    with one matrix (every relaxation sweep on a multigrid level) only do
    the rhs sweep. m[l] = t1[l] - t0[l]*cp[l-1]; cp[l] = t2[l]/m[l];
    inv_m = 1/m."""
    nl = t1.shape[0]
    im = [1.0 / t1[0]]
    cp = [t2[0] * im[0]]
    for l in range(1, nl):
        m = t1[l] - t0[l] * cp[-1]
        im.append(1.0 / m)
        cp.append(t2[l] * im[-1])
    return torch.stack(cp), torch.stack(im)


def solve_factored(cp: torch.Tensor, im: torch.Tensor, t0: torch.Tensor,
                   rhs: torch.Tensor) -> torch.Tensor:
    """Solve with the factors of `factor` (same t0)."""
    nl = rhs.shape[0]
    dp = [rhs[0] * im[0]]
    for l in range(1, nl):
        dp.append((rhs[l] - t0[l] * dp[-1]) * im[l])
    x = [dp[-1]]
    for l in range(nl - 2, -1, -1):
        x.append(dp[l] - cp[l] * x[-1])
    x.reverse()
    return torch.stack(x)
