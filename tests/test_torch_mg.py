"""The port's multigrid (msom_tpu_torch.solvers.mg, fused_mg, ops.tridiag)
against the JAX package on the CPU in float64, from numpy-seeded inputs.

The building blocks (tridiag, neighbor_sum, restrict_cell, prolong_bilinear
with all three BCs, the level coefficients) are held to the JAX functions at
1e-13: the same formulas in the same order, so only the last bits may differ
(the 2x2 mean sums in another order than reduce_window). The plain versions
of the two kernels, `rb_line_sweep` and `residual_norm` on CPU tensors, are
held to the Pallas kernels run with interpret=True over the parameter grid
of tests/test_pallas_mg.py, at its limits (1e-13 for the sweep, 1e-12 for the
residual): they differ in the order of the four-neighbour sum. Whole solves
from one guess must take the same cycles and end at the same nrelax, with
the solution at 1e-11 and the final residual norm at 1e-10 relative: roundoff
differences are damped by the cycles, not amplified. A residual is a
difference of O(1) terms, so two evaluations of it agree to RES_FLOOR in
absolute terms however small the residual has become; the relative limit is
what binds at the loose tolerance the model runs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msom_tpu.ops import tridiag as jtridiag
from msom_tpu.ops.bc import BC as JBC
from msom_tpu.ops.ghost import ghosted as jghosted
from msom_tpu.ops.ghost import neighbor_sum as jneighbor_sum
from msom_tpu.solvers import mg as jmg
from msom_tpu.solvers import pallas_mg
from msom_tpu_torch.ops import tridiag as ttridiag
from msom_tpu_torch.ops.bc import BC as TBC
from msom_tpu_torch.ops.ghost import ghosted as tghosted
from msom_tpu_torch.ops.ghost import neighbor_sum as tneighbor_sum
from msom_tpu_torch.solvers import fused_mg
from msom_tpu_torch.solvers import mg as tmg

torch.set_num_threads(1)

BCS = ["DIRICHLET", "NEUMANN", "PERIODIC"]
SIGNS = [("DIRICHLET", -1.0), ("NEUMANN", 1.0)]
RES_FLOOR = 1e-13


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("nl", [1, 2, 4])
def test_tridiag_matches_jax(nl):
    rng = np.random.default_rng(nl)
    shape = (nl, 12, 16)
    t0 = rng.uniform(-1, 0, shape)
    t2 = rng.uniform(-1, 0, shape)
    t1 = 4.0 - t0 - t2
    rhs = rng.standard_normal(shape)
    cp, im = ttridiag.factor(*map(torch.tensor, (t0, t1, t2)))
    jcp, jim = jtridiag.factor(*map(jnp.asarray, (t0, t1, t2)))
    _close(cp, jcp, 1e-13)
    _close(im, jim, 1e-13)
    x = ttridiag.solve_factored(cp, im, torch.tensor(t0), torch.tensor(rhs))
    _close(x, jtridiag.solve_factored(jcp, jim, jnp.asarray(t0),
                                      jnp.asarray(rhs)), 1e-13)
    xt = ttridiag.thomas(*map(torch.tensor, (t0, t1, t2, rhs)))
    _close(xt, jtridiag.thomas(*map(jnp.asarray, (t0, t1, t2, rhs))), 1e-13)
    # it solves the system it says it solves (t0[0] and t2[-1] are unused)
    xp = np.pad(xt.numpy(), ((1, 1), (0, 0), (0, 0)))
    np.testing.assert_allclose(
        t0 * xp[:-2] + t1 * xp[1:-1] + t2 * xp[2:], rhs, atol=1e-12)


def test_tridiag_takes_profile_coefficients():
    """(nl, n, 1) y-profile factors against an (nl, n, n) right-hand side
    give what the broadcast full fields give, bit for bit."""
    rng = np.random.default_rng(7)
    t0 = torch.tensor(rng.uniform(-1, 0, (3, 8, 1)))
    t2 = torch.tensor(rng.uniform(-1, 0, (3, 8, 1)))
    t1 = 4.0 - t0 - t2
    rhs = torch.tensor(rng.standard_normal((3, 8, 8)))
    cp, im = ttridiag.factor(t0, t1, t2)
    full = [c.expand(3, 8, 8).contiguous() for c in (t0, t1, t2)]
    cpf, imf = ttridiag.factor(*full)
    assert torch.equal(ttridiag.solve_factored(cp, im, t0, rhs),
                       ttridiag.solve_factored(cpf, imf, full[0], rhs))


@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("shape", [(16, 16), (3, 8, 12)])
def test_neighbor_sum_matches_jax(bc, shape):
    a = np.random.default_rng(3).standard_normal(shape)
    got = tneighbor_sum(tghosted(torch.tensor(a), getattr(TBC, bc)))
    want = jneighbor_sum(jghosted(jnp.asarray(a), getattr(JBC, bc)))
    _close(got, want, 1e-13)


@pytest.mark.parametrize("shape", [(64, 64), (3, 32, 32), (2, 2, 16, 16),
                                   (4, 2, 2)])
def test_restrict_cell_matches_jax(shape):
    a = np.random.default_rng(5).standard_normal(shape)
    got = tmg.restrict_cell(torch.tensor(a))
    _close(got, jmg.restrict_cell(jnp.asarray(a)), 1e-13)
    ref = 0.25 * (a[..., ::2, ::2] + a[..., 1::2, ::2]
                  + a[..., ::2, 1::2] + a[..., 1::2, 1::2])
    _close(got, ref, 1e-14)


@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("shape", [(3, 32, 32), (1, 1, 1), (2, 2, 2),
                                   (16, 16)])
def test_prolong_bilinear_matches_jax(bc, shape):
    c = np.random.default_rng(2).standard_normal(shape)
    got = tmg.prolong_bilinear(torch.tensor(c), getattr(TBC, bc))
    assert got.shape == shape[:-2] + (2 * shape[-2], 2 * shape[-1])
    if shape[-1] > 1:
        # (the JAX roll formulation wraps onto itself at m = 1)
        _close(got, jmg.prolong_bilinear(jnp.asarray(c), getattr(JBC, bc)),
               1e-13)
    # the stencil of tests/test_pallas_mg.py, written out
    P = np.asarray(jmg.pad(jnp.asarray(c), getattr(JBC, bc)))
    cc = P[..., 1:-1, 1:-1]
    w, e = P[..., 1:-1, :-2], P[..., 1:-1, 2:]
    s_, n_ = P[..., :-2, 1:-1], P[..., 2:, 1:-1]
    sw, se = P[..., :-2, :-2], P[..., :-2, 2:]
    nw, ne = P[..., 2:, :-2], P[..., 2:, 2:]
    ref = np.empty(got.shape)
    ref[..., 0::2, 0::2] = 9 * cc + 3 * w + 3 * s_ + sw
    ref[..., 0::2, 1::2] = 9 * cc + 3 * e + 3 * s_ + se
    ref[..., 1::2, 0::2] = 9 * cc + 3 * w + 3 * n_ + nw
    ref[..., 1::2, 1::2] = 9 * cc + 3 * e + 3 * n_ + ne
    _close(got, ref / 16.0, 1e-14)


def _setup(nl, n, seed=0, lam_mode=False, xvary=False):
    """tests/test_pallas_mg.py's set-up, for both packages: level data of
    the finest level, two random fields and the metrics."""
    rng = np.random.default_rng(seed)
    L0 = 80.0
    depth = int(np.log2(n))
    s = lam = None
    if lam_mode:
        lamp = -rng.uniform(0.0, 5.0, (nl, n))
        lam = np.broadcast_to(lamp[:, :, None], (nl, n, n)).copy()
        idh0 = np.zeros(nl)
        idh1 = np.zeros(nl)
    else:
        if nl > 1:
            sprof = rng.uniform(0.5, 2.0, (nl - 1, n))
            s = np.broadcast_to(sprof[:, :, None], (nl - 1, n, n)).copy()
            if xvary:
                s = s * rng.uniform(0.9, 1.1, s.shape)
        idh0 = np.r_[0.0, rng.uniform(1, 3, nl - 1)]
        idh1 = np.r_[rng.uniform(1, 3, nl - 1), 0.0]

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.tensor(a)

    jlev = jmg._make_levels(nl, depth, L0, j(s), idh0, idh1, j(lam),
                            jnp.float64)
    tlev = tmg._make_levels(nl, depth, L0, t(s), idh0, idh1, t(lam),
                            torch.float64, device="cpu")
    da = rng.standard_normal((nl, n, n))
    res = rng.standard_normal((nl, n, n))
    return jlev, tlev, da, res, idh0, idh1, L0 / n


@pytest.mark.parametrize("kind", ["stretch", "lam", "xvary", "poisson"])
def test_level_coefficients_match_jax(kind):
    nl = 1 if kind == "poisson" else 3
    jlev, tlev, *_ = _setup(nl, 32, seed=4, lam_mode=kind == "lam",
                            xvary=kind == "xvary")
    assert len(jlev) == len(tlev) == 5
    for jl, tl in zip(jlev, tlev):
        n = jl.t0.shape[-1]
        assert tl.delta == jl.delta
        assert tl.red.shape == (n, n)
        np.testing.assert_array_equal(tl.red.numpy(), np.asarray(jl.red))
        for name in ("s", "lam", "t0", "cp", "im"):
            jf, tf = getattr(jl, name), getattr(tl, name)
            assert (jf is None) == (tf is None), name
            if jf is not None:
                _close(tf.expand(*jf.shape), jf, 1e-13)
        # y-profile coefficients carry profiles at every level, and only
        # they do; the profiles are the fields' columns
        assert (tl.sw is None) == (tl.rp is None) == (kind == "xvary")
        if tl.sw is not None:
            for name in ("t0", "cp", "im"):
                prof = getattr(tl.sw, name)
                assert prof.shape == (nl, n) and prof.is_contiguous()
                assert torch.equal(prof, getattr(tl, name)[..., 0])
            assert (tl.rp.s is None) == (tl.s is None)
            assert (tl.rp.lam is None) == (tl.lam is None)


def test_profile_form_coefficients_build_the_same_levels():
    """s given as (nl-1, N, 1), the form the model's constants keep, builds
    the levels that the full (nl-1, N, N) field builds."""
    rng = np.random.default_rng(9)
    sprof = torch.tensor(rng.uniform(0.5, 2.0, (2, 32, 1)))
    kw = dict(nl=3, N=32, L0=80.0, idh0=np.r_[0.0, 2.0, 2.0],
              idh1=np.r_[1.5, 1.5, 0.0], dtype=torch.float64)
    a = tmg.build_layered_coeffs(s=sprof, **kw)
    b = tmg.build_layered_coeffs(s=sprof.expand(2, 32, 32).contiguous(),
                                 **kw)
    for la, lb in zip(a, b):
        for name in ("t0", "cp", "im"):
            assert torch.equal(getattr(la.sw, name), getattr(lb.sw, name))
        assert torch.equal(la.rp.s, lb.rp.s)


@pytest.mark.parametrize("nl,n", [(1, 64), (3, 64), (4, 128), (2, 256)])
@pytest.mark.parametrize("bc,sign", SIGNS)
def test_plain_sweep_matches_pallas_kernel(nl, n, bc, sign):
    jlev, tlev, da, res, _, _, delta = _setup(nl, n)
    d2 = delta * delta
    want = pallas_mg.rb_line_sweep(jnp.asarray(da), jnp.asarray(res),
                                   jlev[0].sw, d2=d2, sign_x=sign,
                                   sign_y=sign, interpret=True)
    before = fused_mg.sweep_launches
    got = fused_mg.rb_line_sweep(torch.tensor(da), torch.tensor(res),
                                 tlev[0].sw, d2=d2, sign_x=sign, sign_y=sign)
    assert fused_mg.sweep_launches == before      # a CPU tensor: no launch
    _close(got, want, 1e-13)
    # and the level's torch-op route (what a level without profiles runs)
    lvl = tlev[0]
    alt = torch.tensor(da)
    for mask in (lvl.red, ~lvl.red):
        alt = fused_mg.relax_color(tghosted(alt, getattr(TBC, bc)),
                                   torch.tensor(res), lvl.t0, lvl.cp, lvl.im,
                                   mask, d2)
    assert torch.equal(alt, got)


@pytest.mark.parametrize("nl,n", [(1, 64), (4, 128)])
@pytest.mark.parametrize("bc,sign", SIGNS)
def test_plain_residual_matches_pallas_kernel(nl, n, bc, sign):
    jlev, tlev, a, b, idh0, idh1, delta = _setup(nl, n)
    r_want, m_want = pallas_mg.residual_norm(
        jnp.asarray(a), jnp.asarray(b), jlev[0].rp, delta=delta, idh0=idh0,
        idh1=idh1, sign_x=sign, sign_y=sign, interpret=True)
    before = fused_mg.residual_launches
    r_got, m_got = fused_mg.residual_norm(
        torch.tensor(a), torch.tensor(b), tlev[0].rp, delta=delta, idh0=idh0,
        idh1=idh1, sign_x=sign, sign_y=sign)
    assert fused_mg.residual_launches == before
    _close(r_got, r_want, 1e-12)
    assert m_got.ndim == 0
    np.testing.assert_allclose(float(m_got), float(m_want), rtol=1e-12)
    r_lvl, m_lvl = tmg._residual_layered(torch.tensor(a), torch.tensor(b),
                                         tlev[0], getattr(TBC, bc), idh0,
                                         idh1)
    assert torch.equal(r_lvl, r_got) and torch.equal(m_lvl, m_got)


def test_plain_versions_match_pallas_kernels_in_the_modal_shape():
    """No vertical coupling, a Helmholtz term per mode (iBu)."""
    jlev, tlev, da, res, idh0, idh1, delta = _setup(4, 128, lam_mode=True)
    assert tlev[0].rp.s is None and tlev[0].rp.lam.shape == (4, 128)
    d2 = delta * delta
    want = pallas_mg.rb_line_sweep(jnp.asarray(da), jnp.asarray(res),
                                   jlev[0].sw, d2=d2, sign_x=-1.0,
                                   sign_y=-1.0, interpret=True)
    got = fused_mg.rb_line_sweep(torch.tensor(da), torch.tensor(res),
                                 tlev[0].sw, d2=d2, sign_x=-1.0, sign_y=-1.0)
    _close(got, want, 1e-13)
    r_want, m_want = pallas_mg.residual_norm(
        jnp.asarray(da), jnp.asarray(res), jlev[0].rp, delta=delta,
        idh0=idh0, idh1=idh1, sign_x=-1.0, sign_y=-1.0, interpret=True)
    r_got, m_got = fused_mg.residual_norm(
        torch.tensor(da), torch.tensor(res), tlev[0].rp, delta=delta,
        idh0=idh0, idh1=idh1, sign_x=-1.0, sign_y=-1.0)
    _close(r_got, r_want, 1e-12)
    np.testing.assert_allclose(float(m_got), float(m_want), rtol=1e-12)


@pytest.mark.parametrize("nl,n", [(1, 64), (3, 64), (1, 128), (3, 128)])
def test_plain_periodic_x_matches_pallas_kernels(nl, n):
    """periodic_x: x wraps, the ghost above row 0 is row 7 and the one
    below row n - 1 row n - 8 (in a sweep the rows of its input, for both
    colours), as the Pallas kernels' clamped 8-row halo blocks give them;
    two sweeps and a residual, f64 at 1e-12."""
    jlev, tlev, da, res, idh0, idh1, delta = _setup(nl, n, seed=3)
    d2 = delta * delta
    kw = dict(d2=d2, sign_x=-1.0, sign_y=-1.0, periodic_x=True)
    want = jnp.asarray(da)
    for _ in range(2):
        want = pallas_mg.rb_line_sweep(want, jnp.asarray(res), jlev[0].sw,
                                       interpret=True, **kw)
    got = fused_mg.relax(torch.tensor(da), torch.tensor(res), tlev[0].sw,
                         nrelax=2, **kw)
    _close(got, want, 1e-12)
    rkw = dict(delta=delta, idh0=idh0, idh1=idh1, sign_x=-1.0, sign_y=-1.0,
               periodic_x=True)
    r_want, m_want = pallas_mg.residual_norm(
        jnp.asarray(da), jnp.asarray(res), jlev[0].rp, interpret=True, **rkw)
    r_got, m_got = fused_mg.residual_norm(torch.tensor(da),
                                          torch.tensor(res), tlev[0].rp,
                                          **rkw)
    _close(r_got, r_want, 1e-12)
    np.testing.assert_allclose(float(m_got), float(m_want), rtol=1e-12)


def test_periodic_x_ghost_rows_are_not_a_y_law():
    """The fault of the JAX package's periodic_x: its y ghosts are rows 7
    and n - 8 (the clamped halo blocks), not y-periodic (nor any wall
    law). Both packages' results differ from the y-periodic sweep and
    residual by O(1)."""
    jlev, tlev, da, res, idh0, idh1, delta = _setup(3, 64, seed=3)
    d2 = delta * delta
    lvl = tlev[0]
    per = torch.tensor(da)
    for mask in (lvl.red, ~lvl.red):
        per = fused_mg.relax_color(tghosted(per, TBC.PERIODIC),
                                   torch.tensor(res), lvl.t0, lvl.cp, lvl.im,
                                   mask, d2)
    r_per, _ = fused_mg.residual_plain(
        tghosted(torch.tensor(da), TBC.PERIODIC), torch.tensor(res), lvl.s,
        lvl.lam, delta, idh0, idh1)
    kw = dict(d2=d2, sign_x=-1.0, sign_y=-1.0, periodic_x=True)
    rkw = dict(delta=delta, idh0=idh0, idh1=idh1, sign_x=-1.0, sign_y=-1.0,
               periodic_x=True)
    sweeps = [np.asarray(pallas_mg.rb_line_sweep(
        jnp.asarray(da), jnp.asarray(res), jlev[0].sw, interpret=True,
        **kw)), fused_mg.rb_line_sweep(torch.tensor(da), torch.tensor(res),
                                       lvl.sw, **kw).numpy()]
    resids = [np.asarray(pallas_mg.residual_norm(
        jnp.asarray(da), jnp.asarray(res), jlev[0].rp, interpret=True,
        **rkw)[0]), fused_mg.residual_norm(
        torch.tensor(da), torch.tensor(res), lvl.rp, **rkw)[0].numpy()]
    for got in sweeps:
        assert np.abs(got - per.numpy()).max() > 0.1
        # only the rows next to the y edges differ from the y law
        assert np.abs(got - per.numpy())[:, 8:-8].max() < 1e-12
    for got in resids:
        assert np.abs(got - r_per.numpy()).max() > 0.1
        assert np.abs(got - r_per.numpy())[:, 1:-1].max() < 1e-12


def test_mixed_signs_follow_each_axis():
    """sign_x and sign_y are separate: a Neumann-in-x, Dirichlet-in-y sweep
    equals neither pure one, and its ghosts are the axis' own."""
    _, tlev, da, res, idh0, idh1, delta = _setup(2, 16)
    g = fused_mg._pad_signed(torch.tensor(da), 1.0, -1.0).p
    assert torch.equal(g[:, 1:-1, 0], g[:, 1:-1, 1])
    assert torch.equal(g[:, 0, 1:-1], -g[:, 1, 1:-1])
    assert torch.equal(g[:, 0, 0], -g[:, 1, 1])
    kw = dict(d2=delta * delta)
    outs = [fused_mg.rb_line_sweep(torch.tensor(da), torch.tensor(res),
                                   tlev[0].sw, sign_x=sx, sign_y=sy, **kw)
            for sx, sy in ((1.0, -1.0), (1.0, 1.0), (-1.0, -1.0))]
    assert not torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


def test_relax_on_the_cpu_is_plain_sweeps():
    """relax on a CPU tensor: nrelax plain sweeps, no launch counted."""
    _, tlev, da, res, _, _, delta = _setup(2, 32)
    kw = dict(d2=delta * delta, sign_x=-1.0, sign_y=1.0)
    before = fused_mg.sweep_launches, fused_mg.sweeps
    got = fused_mg.relax(torch.tensor(da), torch.tensor(res), tlev[0].sw,
                         nrelax=3, **kw)
    assert (fused_mg.sweep_launches, fused_mg.sweeps) == before
    want = torch.tensor(da)
    for _ in range(3):
        want = fused_mg.rb_line_sweep(want, torch.tensor(res), tlev[0].sw,
                                      **kw)
    assert torch.equal(got, want)


def test_residual_max_carries_a_nan():
    _, tlev, a, b, idh0, idh1, delta = _setup(2, 16)
    a[1, 3, 4] = np.nan
    _, m = fused_mg.residual_norm(torch.tensor(a), torch.tensor(b),
                                  tlev[0].rp, delta=delta, idh0=idh0,
                                  idh1=idh1, sign_x=-1.0, sign_y=-1.0)
    assert torch.isnan(m)


SOLVES = {
    # name: (bc, coefficients, nl, tolerance)
    "dirichlet_stretch": ("DIRICHLET", "stretch", 3, 1e-8),
    "dirichlet_xvary": ("DIRICHLET", "xvary", 3, 1e-8),
    "neumann_lam": ("NEUMANN", "lam", 3, 1e-8),
    "periodic_lam": ("PERIODIC", "lam", 2, 1e-8),
    "periodic_xvary_lam": ("PERIODIC", "xvary_lam", 3, 1e-6),
    "loose": ("DIRICHLET", "stretch", 4, 1e-3),
}


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_solve_layered_matches_jax(name):
    bc, coeffs, nl, tol = SOLVES[name]
    rng = np.random.default_rng(1)
    n = 64
    s = lam = None
    idh0 = idh1 = None
    if coeffs in ("stretch", "xvary", "xvary_lam"):
        sprof = rng.uniform(0.5, 2.0, (nl - 1, n))
        s = np.broadcast_to(sprof[:, :, None], (nl - 1, n, n)).copy()
        if coeffs != "stretch":
            s = s * rng.uniform(0.9, 1.1, s.shape)
        idh0 = np.r_[0.0, rng.uniform(1, 3, nl - 1)]
        idh1 = np.r_[rng.uniform(1, 3, nl - 1), 0.0]
    if coeffs in ("lam", "xvary_lam"):
        lamp = -rng.uniform(0.5, 5.0, (nl, n))
        lam = np.broadcast_to(lamp[:, :, None], (nl, n, n)).copy()
    b = rng.standard_normal((nl, n, n))
    a0 = 0.1 * rng.standard_normal((nl, n, n))

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.tensor(a)

    a_j, st_j = jmg.solve_layered(j(a0), j(b), L0=80.0, s=j(s), idh0=idh0,
                                  idh1=idh1, lam=j(lam),
                                  bc=getattr(JBC, bc), tolerance=tol)
    before = fused_mg.sweep_launches, fused_mg.residual_launches
    a_t, st_t = tmg.solve_layered(t(a0), t(b), L0=80.0, s=t(s), idh0=idh0,
                                  idh1=idh1, lam=t(lam),
                                  bc=getattr(TBC, bc), tolerance=tol)
    assert (fused_mg.sweep_launches, fused_mg.residual_launches) == before
    assert isinstance(st_t.iters, int) and isinstance(st_t.nrelax, int)
    assert isinstance(st_t.resa, float) and isinstance(st_t.resb, float)
    assert 1 <= st_t.iters < 100 and st_t.resa <= tol
    assert st_t.iters == int(st_j.iters)
    assert st_t.nrelax == int(st_j.nrelax)
    np.testing.assert_allclose(st_t.resb, float(st_j.resb), rtol=1e-12)
    np.testing.assert_allclose(st_t.resa, float(st_j.resa), rtol=1e-10,
                               atol=RES_FLOOR)
    _close(a_t, a_j, 1e-11 * np.abs(np.asarray(a_j)).max())


def test_solve_layered_cycle_rules():
    """At least one cycle even from the solution; nitermax caps the cycles;
    nrelax stays within [2, 100] and moves by one a cycle."""
    rng = np.random.default_rng(3)
    b = torch.tensor(rng.standard_normal((2, 32, 32)))
    kw = dict(L0=80.0, s=torch.full((1, 32, 1), 1.3, dtype=torch.float64),
              idh0=np.r_[0.0, 2.0], idh1=np.r_[1.5, 0.0])
    a, st = tmg.solve_layered(torch.zeros_like(b), b, tolerance=1e-9, **kw)
    again, st2 = tmg.solve_layered(a, b, tolerance=1e-3, **kw)
    assert st2.iters == 1 and st2.resb <= 1e-9 and st2.nrelax == 4
    _, st3 = tmg.solve_layered(torch.zeros_like(b), b, tolerance=1e-12,
                               nitermax=3, **kw)
    assert st3.iters == 3 and st3.resa > 1e-12
    assert abs(st3.nrelax - 4) <= 3 and st3.nrelax >= 2
    # a NaN right-hand side ends after the one obligatory cycle
    _, st4 = tmg.solve_layered(torch.zeros_like(b), b * float("nan"), **kw)
    assert st4.iters == 1 and np.isnan(st4.resa)


@pytest.mark.parametrize("bc,with_lam", [
    ("DIRICHLET", False), ("DIRICHLET", True), ("NEUMANN", True),
    ("PERIODIC", True)])
def test_solve_poisson_matches_jax(bc, with_lam):
    """(The pure Neumann and periodic Poisson problems are singular.)"""
    rng = np.random.default_rng(11)
    n = 64
    b = rng.standard_normal((n, n))
    a0 = np.zeros((n, n))
    lam = -rng.uniform(0.5, 3.0, (n, 1)) * np.ones((n, n)) \
        if with_lam else None
    a_j, st_j = jmg.solve_poisson(
        jnp.asarray(a0), jnp.asarray(b), L0=10.0,
        lam=None if lam is None else jnp.asarray(lam), bc=getattr(JBC, bc),
        tolerance=1e-9)
    a_t, st_t = tmg.solve_poisson(
        torch.tensor(a0), torch.tensor(b), L0=10.0,
        lam=None if lam is None else torch.tensor(lam), bc=getattr(TBC, bc),
        tolerance=1e-9)
    assert a_t.shape == (n, n)
    assert (st_t.iters, st_t.nrelax) == (int(st_j.iters), int(st_j.nrelax))
    np.testing.assert_allclose(st_t.resa, float(st_j.resa), rtol=1e-10,
                               atol=RES_FLOOR)
    _close(a_t, a_j, 1e-11 * np.abs(np.asarray(a_j)).max())


def test_cuda_tensor_with_profiles_does_not_fall_back():
    """The wrappers route on the tensor's device alone: only a CPU tensor
    takes the plain version. A meta tensor stands in for any other device
    here."""
    _, tlev, da, res, idh0, idh1, delta = _setup(2, 16)
    meta = torch.empty((2, 16, 16), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_mg.rb_line_sweep(meta, meta, tlev[0].sw, d2=1.0, sign_x=-1.0,
                               sign_y=-1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_mg.relax(meta, meta, tlev[0].sw, nrelax=3, d2=1.0,
                       sign_x=-1.0, sign_y=-1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_mg.residual_norm(meta, meta, tlev[0].rp, delta=delta,
                               idh0=idh0, idh1=idh1, sign_x=-1.0,
                               sign_y=-1.0)


def test_bound_work_counts_each_array_once():
    nbytes, nops = fused_mg.sweep_bound_work(4, 2048, 4)
    assert nbytes == 3 * 4 * 2048 ** 2 * 4 + 3 * 4 * 2048 * 4
    assert nops == 10 * 4 * 2048 ** 2
    # a launch of four sweeps moves the arrays once, computes four times
    assert fused_mg.sweep_bound_work(4, 2048, 4, 4) == (nbytes, 4 * nops)
    nbytes, _ = fused_mg.residual_bound_work(4, 2048, 4, True, False)
    assert nbytes == 3 * 4 * 2048 ** 2 * 4 + 3 * 2048 * 4
    nbytes, _ = fused_mg.residual_bound_work(4, 2048, 4, False, True)
    assert nbytes == 3 * 4 * 2048 ** 2 * 4 + 4 * 2048 * 4
