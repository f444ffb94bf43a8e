"""The qg-node family's building blocks in the port (ops.vertex, the folded
DST-I, the nodal spectral inversion, the vertex multigrid and the plain
version of its masked sweep, kernel K6) against the JAX package on the CPU
in float64, from numpy-seeded inputs.

The vertex ops, the transfers and the fold compute the same formulas in the
same order: 1e-13 relative. The level coefficients and the residual: 1e-13.
The plain sweep against relax_v (XLA) and once against the Pallas kernel in
interpret mode: 1e-12 after three sweeps (the sums are the same, the
selection of a colour is a `where` here and an arithmetic blend there).
Whole masked solves from one guess take the same cycles and agree to
1e-12: roundoff differences are damped by the cycles."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msom_tpu.ops import vertex as jvertex
from msom_tpu.ops.stretch import layer_metrics
from msom_tpu.solvers import ctdst as jctdst
from msom_tpu.solvers import pallas_vmg
from msom_tpu.solvers import spectral as jspec
from msom_tpu.solvers import vmg as jvmg
from msom_tpu_torch.models.qg_node import coastline_mask
from msom_tpu_torch.ops import vertex as tvertex
from msom_tpu_torch.solvers import ctdst as tctdst
from msom_tpu_torch.solvers import fused_vmg
from msom_tpu_torch.solvers import spectral as tspec
from msom_tpu_torch.solvers import vmg as tvmg

torch.set_num_threads(1)

L0 = 100.0


def _close(got, want, tol=1e-13):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-300))


SHAPES = [(9, 9), (3, 17, 17), (2, 2, 33, 33)]


@pytest.mark.parametrize("shape", SHAPES)
def test_ring_rules_match_jax(shape):
    rng = np.random.default_rng(len(shape))
    a, p = rng.standard_normal(shape), rng.standard_normal(shape)
    ta, tp = torch.tensor(a), torch.tensor(p)
    ja, jp = jnp.asarray(a), jnp.asarray(p)
    n = shape[-1]
    side = rng.standard_normal(shape[:-2] + (n - 2,))
    _close(tvertex.interior(ta), jvertex.interior(ja))
    _close(tvertex.set_ring(ta, torch.tensor(side), 1.5, -2.0, 0.25, 3.0),
           jvertex.set_ring(ja, jnp.asarray(side), 1.5, -2.0, 0.25, 3.0))
    _close(tvertex.bc_psi(ta, 0.5), jvertex.bc_psi(ja, 0.5))
    for bc_fac in (0.0, 1.0, 0.3):
        _close(tvertex.bc_deriv(ta, tp, bc_fac, 0.7),
               jvertex.bc_deriv(ja, jp, bc_fac, 0.7))
        _close(tvertex.bc_deriv_rel(ta, tp, bc_fac, 0.7),
               jvertex.bc_deriv_rel(ja, jp, bc_fac, 0.7))
    z = tvertex.zero_ring_(ta.clone())
    _close(z, jvertex.set_ring(ja, 0., 0., 0., 0.))
    _close(tvertex.default_mask(n - 1, torch.float64),
           jvertex.default_mask(n - 1, jnp.float64))


@pytest.mark.parametrize("shape", SHAPES + [(4, 5, 5), (3, 3)])
def test_transfers_match_jax(shape):
    """The restrictions at odd sizes (2^k + 1 and others) and the
    prolongation, against the JAX pad/reshape and interleave forms."""
    f = np.random.default_rng(shape[-1]).standard_normal(shape)
    tf, jf = torch.tensor(f), jnp.asarray(f)
    for name in ("vrestrict_inject", "vrestrict_weighted",
                 "vrestrict_weighted16", "vprolong"):
        got = getattr(tvertex, name)(tf)
        assert got.is_contiguous()
        _close(got, getattr(jvertex, name)(jf))
    # the prolongation reproduces the coarse nodes and is the inverse of
    # injection
    c = tvertex.vprolong(tf)
    assert torch.equal(tvertex.vrestrict_inject(c), tf)


@pytest.mark.parametrize("L", [1, 2])
def test_folded_dst1_matches_jax(L):
    N = 64
    rng = np.random.default_rng(L)
    x = rng.standard_normal((2, N - 1, N - 1))
    jf, jperm = jctdst.build_fold1(N, jnp.float64, L=L)
    tf, tperm = tctdst.build_fold1(N, torch.float64, "cpu", L=L)
    np.testing.assert_array_equal(tperm, jperm)
    assert (tf.N, tf.L) == (jf.N, jf.L)
    for a, b in zip(tf.Mes + (tf.Mleaf,), jf.Mes + (jf.Mleaf,)):
        _close(a, b, 0.0)
    xt, xj = torch.tensor(x), jnp.asarray(x)
    for fwd, inv in (("fdst1_x", "ifdst1_x"), ("fdst1_y", "ifdst1_y")):
        y = getattr(tctdst, fwd)(tf, xt)
        _close(y, getattr(jctdst, fwd)(jf, xj))
        _close(getattr(tctdst, inv)(tf, y),
               getattr(jctdst, inv)(jf, y.numpy()))
        _close(getattr(tctdst, inv)(tf, y), x, 1e-13)
    # the permuted output is the DST-I of the natural order
    S1 = tspec.dst1_matrix(N)
    _close(tctdst.fdst1_x(tf, xt), (x @ S1.T)[..., tperm])
    assert tctdst.build_fold1(96, torch.float64, "cpu") == (None, None)


@pytest.mark.parametrize("nl,dtype,N", [(1, "float64", 32), (3, "float64", 32),
                                        (3, "float32", 512)])
def test_build_spectral_node_matches_jax(nl, dtype, N):
    """The constants (the fold and its permuted inv_den in f32 at 512, the
    DST-I basis otherwise) and the solve, against the JAX builder."""
    dh = np.array([0.2, 0.3, 0.5])[:nl] if nl > 1 else np.array([1.0])
    kw = dict(nl=nl, N=N, L0=L0, dh=dh,
              s_profile=None if nl == 1 else np.array([2116.0, 1081.0]),
              iRd2_low=0.0 if nl > 1 else 540.5)
    j = jspec.build_spectral_node(dtype=jnp.dtype(dtype), **kw)
    t = tspec.build_spectral_node(dtype=getattr(torch, dtype), device="cpu",
                                  **kw)
    tol = 1e-13 if dtype == "float64" else 1e-6
    _close(t.inv_den, j.inv_den, tol)
    assert (t.l2m is None) == (j.l2m is None)
    if nl > 1:
        _close(t.l2m, j.l2m, tol)
        _close(t.m2l, j.m2l, tol)
    assert isinstance(t.fac, tctdst.FoldedDST1) == (dtype == "float32")
    if t.fac is None:
        _close(t.S, j.S, 0.0)
    q = np.random.default_rng(nl).standard_normal((nl, N - 1, N - 1))
    got = tspec.solve_spectral(t, torch.as_tensor(q, dtype=t.inv_den.dtype))
    want = jspec.solve_spectral(j, jnp.asarray(q, j.inv_den.dtype))
    _close(got, want, 1e-12 if dtype == "float64" else 1e-5)


def _levels(nl, N, case):
    """Both packages' vertex levels: a coastline mask with an x-varying S2,
    the default mask with uniform S2, or the barotropic Helmholtz shift."""
    rng = np.random.default_rng(nl + N)
    _, idh0, idh1 = layer_metrics(np.full(nl, 1.0 / nl))
    mask = coastline_mask(N) if case == "coast" else None
    S2 = None
    if nl > 1:
        S2 = np.full((nl - 1, N + 1, N + 1), 2.0)
        if case == "coast":
            S2 = 1.0 + 0.3 * rng.standard_normal((nl - 1, N + 1, N + 1)) ** 2
    lam = 540.5 if case == "baro" else 0.0
    kw = dict(nl=nl, N=N, L0=L0, idh0=idh0, idh1=idh1, iRd2_low=lam)
    jl = jvmg.build_vlevels(
        S2=None if S2 is None else jnp.asarray(S2),
        mask=None if mask is None else jnp.asarray(mask),
        dtype=jnp.float64, pallas=False, **kw)
    tl = tvmg.build_vlevels(
        S2=None if S2 is None else torch.tensor(S2),
        mask=None if mask is None else torch.tensor(mask),
        dtype=torch.float64, device="cpu", **kw)
    return jl, tl, idh0, idh1


CASES = [(3, 32, "coast"), (2, 16, "uniform"), (1, 16, "baro")]


@pytest.mark.parametrize("nl,N,case", CASES)
def test_vlevels_and_residual_match_jax(nl, N, case):
    jl, tl, idh0, idh1 = _levels(nl, N, case)
    assert len(tl) == len(jl) == int(np.log2(N))
    for t, j in zip(tl, jl):
        assert t.delta == j.delta and t.lam == j.lam
        for name in ("mask", "t0", "cp", "im", "red"):
            want = np.broadcast_to(np.asarray(getattr(j, name)),
                                   getattr(t, name).shape)
            _close(getattr(t, name).to(torch.float64), want)
            assert getattr(t, name).is_contiguous()
        assert (t.S2 is None) == (j.S2 is None)
        if t.S2 is not None:
            _close(t.S2, j.S2, 0.0)
    rng = np.random.default_rng(1)
    n = N + 1
    a, b = rng.standard_normal((2, nl, n, n))
    r_t, m_t = tvmg.residual_v(torch.tensor(a), torch.tensor(b), tl[0],
                               idh0, idh1)
    r_j, m_j = jvmg.residual_v(jnp.asarray(a), jnp.asarray(b), jl[0],
                               idh0, idh1)
    _close(r_t, r_j)
    assert abs(m_t.item() - float(m_j)) <= 1e-13 * float(m_j)


@pytest.mark.parametrize("field", ["mask", "t0", "cp", "im"])
def test_vlevel_refuses_a_layout_the_sweep_does_not_read(field):
    """A level is checked once, when it is made: a non-contiguous field, a
    field of another dtype or a cut mask raises there, not at a launch."""
    _, tl, _, _ = _levels(3, 16, "coast")
    lvl = tl[0]
    bad = getattr(lvl, field)
    for wrong in (bad.transpose(-1, -2), bad.float(), bad[..., :-1]):
        with pytest.raises(ValueError, match="VLevel"):
            dataclasses.replace(lvl, **{field: wrong})
    assert dataclasses.replace(lvl, t0=lvl.t0.clone()).t0.is_contiguous()


@pytest.mark.parametrize("nl,N,case", CASES)
def test_plain_sweep_matches_relax_v(nl, N, case):
    """vrb_sweep on a CPU tensor is relax_v's body: three sweeps on every
    level, the finest with its coastline."""
    jl, tl, _, _ = _levels(nl, N, case)
    rng = np.random.default_rng(nl)
    for t, j in zip(tl, jl):
        n = t.mask.shape[-1]
        da, res = rng.standard_normal((2, nl, n, n))
        got = torch.tensor(da)
        before = fused_vmg.launches
        for _ in range(3):
            got = fused_vmg.vrb_sweep(got, torch.tensor(res), t)
        assert fused_vmg.launches == before
        _close(got, jvmg.relax_v(jnp.asarray(da), jnp.asarray(res), j, 3),
               1e-12)
        _close(tvmg.relax_v(torch.tensor(da), torch.tensor(res), t, 3), got,
               0.0)


def test_plain_sweep_matches_pallas_kernel():
    """The plain version against the Pallas kernel in interpret mode on a
    coastline-masked level with an x-varying S2 (n = 65, two tiles)."""
    N, nl = 64, 3
    jl, tl, _, _ = _levels(nl, N, "coast")
    _, idh0, idh1 = layer_metrics(np.full(nl, 1.0 / nl))
    j = jl[0]
    vsw = pallas_vmg.build_vsweep(np.broadcast_to(j.t0, (nl, N + 1, N + 1)),
                                  np.broadcast_to(j.cp, (nl, N + 1, N + 1)),
                                  np.broadcast_to(j.im, (nl, N + 1, N + 1)),
                                  j.mask, jnp.float64)
    assert vsw is not None
    rng = np.random.default_rng(0)
    da, res = rng.standard_normal((2, nl, N + 1, N + 1)) * tl[0].mask.numpy()
    want, got = jnp.asarray(da), torch.tensor(da)
    for _ in range(2):
        want = pallas_vmg.vrb_sweep(want, jnp.asarray(res), vsw,
                                    d2=j.delta ** 2, interpret=True)
        got = fused_vmg.vrb_sweep(got, torch.tensor(res), tl[0])
    _close(got, want, 1e-12)


@pytest.mark.parametrize("nl,N,case", CASES)
def test_vpoisson_matches_jax(nl, N, case):
    """A whole masked solve from a zero guess at tol 1e-10: the same cycles,
    the same solution; the solution solves the system."""
    jl, tl, idh0, idh1 = _levels(nl, N, case)
    b = np.random.default_rng(3).standard_normal((nl, N + 1, N + 1)) \
        * tl[0].mask.numpy()
    kw = dict(idh0=tuple(idh0), idh1=tuple(idh1), tolerance=1e-10)
    a_t, st_t = tvmg.vpoisson(torch.zeros(b.shape, dtype=torch.float64),
                              torch.tensor(b), levels=tl, **kw)
    a_j, st_j = jvmg.vpoisson(jnp.zeros(b.shape), jnp.asarray(b), levels=jl,
                              **kw)
    assert st_t.iters == int(st_j.iters) >= 1
    assert st_t.nrelax == 5 and st_t.resa <= 1e-10
    _close(a_t, a_j, 1e-12)
    assert abs(st_t.resb - float(st_j.resb)) <= 1e-13 * float(st_j.resb)


def test_vpoisson_stall_cutoff_in_f32():
    """In f32 an unreachable tolerance stops after the first cycle that
    fails to cut the residual by 10%, as the JAX solver does; in f64 the
    cutoff is off and the solve runs to nitermax."""
    nl, N = 2, 16
    jl, tl, idh0, idh1 = _levels(nl, N, "uniform")
    b = np.random.default_rng(4).standard_normal((nl, N + 1, N + 1)) \
        * tl[0].mask.numpy()
    kw = dict(idh0=tuple(idh0), idh1=tuple(idh1), tolerance=1e-30)
    tl32 = [dataclasses.replace(
        lv, **{k: getattr(lv, k).float() for k in ("mask", "t0", "cp", "im",
                                                   "S2")
               if getattr(lv, k) is not None}) for lv in tl]
    _, st = tvmg.vpoisson(torch.zeros(b.shape), torch.tensor(b).float(),
                          levels=tl32, **kw)
    assert 1 < st.iters < 30
    _, st64 = tvmg.vpoisson(torch.zeros(b.shape, dtype=torch.float64),
                            torch.tensor(b), levels=tl, nitermax=12, **kw)
    assert st64.iters == 12
