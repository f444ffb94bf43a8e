"""The plain version of the port's fused qg-node tendency (kernel K5,
msom_tpu_torch.models.fused_node_rhs) against the JAX package's rhs_pv on
the CPU in float64, for the five cases of tests/test_pallas_node_rhs.py and
two at the CUDA kernel's strip edges (N = 24, where one strip holds all
four walls; bench.py's curved coastline), and on the coupled case and those
two against the Pallas kernel in interpret mode; the wrapper's routing on a
CPU tensor and for an x-varying S2; the bound count.

Tolerance: 1e-12 of max|dq|. The plain version runs the same formulas as
rhs_pv; the wind is the same expression of t, broadcast from a column
instead of evaluated on a full grid. Against the Pallas kernel, which sums
the terms in another order, the same 1e-12 holds."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msom_tpu.models import pallas_node_rhs as pnk
from msom_tpu.models import qg_node as jqn
from msom_tpu.ops import vertex as jvertex
from msom_tpu_torch.models import fused_node_rhs
from msom_tpu_torch.models import qg_node as tqn

torch.set_num_threads(1)

T_EVAL = 0.37


def _kw(**kw):
    base = dict(N=64, nl=3, L0=100.0, f0=46.5, beta=0.5, hEkb=1e-3,
                tau0=1e-3, tau1=5e-4, tf1=2.0, tf2=3.0, dy_ws=0.3, nu=5.0,
                dh=(0.2, 0.3, 0.5), N2=(1.0, 2.0), noise_init=1e-3,
                bc_fac=0.0, DT=5e-2, tend=1.0, dtout=1.0, CFL=0.2,
                TOLERANCE=1e-8, dtype="float64")
    base.update(kw)
    return base


def _coupled_inputs(N, nl=3):
    """tests/test_pallas_node_rhs.py's coupled case: PG coupling,
    topography, a 3-D forcing and an island in the mask."""
    rng = np.random.default_rng(3)
    yv = np.arange(N + 1)[:, None] * (100.0 / N) * np.ones((N + 1, N + 1))
    m = np.array(jvertex.default_mask(N, jnp.float64))
    m[20:26, 30:36] = 0.0
    return dict(
        psi_pg=1e-3 * np.sin(np.pi * yv / 100.0)[None]
        * np.ones((nl, N + 1, N + 1)),
        topo=0.02 * np.sin(2 * np.pi * yv / 100.0)
        * np.sin(np.pi * yv.T / 100.0),
        q_forcing_3d=1e-5 * rng.standard_normal((nl, N + 1, N + 1)),
        mask=m)


def _coast_inputs(N):
    """bench.py's curved coastline (qg_node.coastline_mask), handed to both
    packages as numpy."""
    return dict(mask=tqn.coastline_mask(N))


# name: (config overrides, the numpy inputs of build_constants at N)
CASES = {
    "freeslip": ({}, None),
    "noslip_biharmonic": (dict(bc_fac=1.0, nu4=50.0), None),
    "coupled": (dict(bc_fac=1.0, nu4=50.0, flag_ms=1), _coupled_inputs),
    "barotropic": (dict(nl=1, dh=(1.0,), N2=(1.0,), gp_low=4.0), None),
    "ragged96": (dict(N=96), None),
    "allwalls24": (dict(N=24, bc_fac=1.0, nu4=50.0), None),
    "coast": ({}, _coast_inputs),
}


def _setup(name):
    """(jcfg, jconst, tcfg, tconst, q, psi) from one numpy psi."""
    over, make_inputs = CASES[name]
    kw = _kw(**over)
    jcfg, tcfg = jqn.NodeQGConfig(**kw), tqn.NodeQGConfig(**kw)
    inputs = make_inputs(kw["N"]) if make_inputs else {}
    jconst = jqn.build_constants(jcfg, **inputs)
    tconst = tqn.build_constants(tcfg, device="cpu", **inputs)
    M = kw["N"] + 1
    rng = np.random.default_rng(4)
    psi = 1e-3 * rng.uniform(-1, 1, (kw["nl"], M, M)) \
        + 0.01 * rng.standard_normal((kw["nl"], M, M))
    psi = np.asarray(jvertex.bc_psi(jnp.asarray(psi)))
    q = np.asarray(jqn.comp_q(jcfg, jconst, jnp.asarray(psi)))
    return jcfg, jconst, tcfg, tconst, q, psi


def _close(got, want, tol=1e-12):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_rhs_pv(name):
    jcfg, jconst, tcfg, tconst, q, psi = _setup(name)
    t = jnp.asarray(T_EVAL, jnp.float64)
    want = jqn.rhs_pv(jcfg, jconst, jnp.asarray(q), jnp.asarray(psi), t)
    tt = torch.tensor(T_EVAL, dtype=torch.float64)
    qf = tqn.q_forcing_profile(tcfg, tconst.yv[:, 0], tt)
    _close(qf, jqn.q_forcing_profile(jcfg, jconst.yv[:, 0], t), 1e-15)
    before = fused_node_rhs.launches
    got = fused_node_rhs.rhs_fused_node(tcfg, tconst, torch.tensor(q),
                                        torch.tensor(psi), qf)
    assert fused_node_rhs.launches == before
    _close(got, want)
    # rhs_pv routes a CPU tensor through the wrapper; comp_q agrees too
    _close(tqn.rhs_pv(tcfg, tconst, torch.tensor(q), torch.tensor(psi), tt),
           want)
    _close(tqn.comp_q(tcfg, tconst, torch.tensor(psi)), q, 1e-13)


def _with_kernel_data(jcfg, jconst):
    """jconst with the Pallas kernel's data: the package's own, or, below
    the smallest grid it picks a tile for (M < 65), data built here with a
    tile of 8 rows, the smallest the kernel takes (uncoupled cases only)."""
    if jconst.nrhsk is not None:
        return jconst
    assert not (np.any(np.asarray(jconst.psi_pg))
                or np.any(np.asarray(jconst.topo))
                or jconst.q_forcing_3d is not None)
    M, T = jcfg.N + 1, 8
    s2 = pnk._tile_profile_ragged(np.asarray(jconst.S2)[..., 0], T, pnk._H,
                                  (M + T - 1) // T)
    return dataclasses.replace(jconst, nrhsk=pnk.NodeRhsData(
        S2=jnp.asarray(s2), T=T, has_pg=False, has_topo=False,
        has_qf3=False))


@pytest.mark.parametrize("name", ["allwalls24", "coast", "coupled"])
def test_plain_version_matches_pallas_kernel(name):
    """Against `_node_kernel` in interpret mode on the coupled case (every
    option: pg, topo, qf3, flag_ms, an island, no slip, nu4), at N = 24
    (no slip, nu4) and on bench's coastline."""
    jcfg, jconst, tcfg, tconst, q, psi = _setup(name)
    jconst = _with_kernel_data(jcfg, jconst)
    assert tconst.S2_prof is not None
    assert tconst.has_pg == tconst.has_topo == (name == "coupled")
    t = jnp.asarray(T_EVAL, jnp.float64)
    qf = jqn.q_forcing_profile(jcfg, jconst.yv[:, 0], t)
    want = pnk.rhs_fused_node(jcfg, jconst, jnp.asarray(q), jnp.asarray(psi),
                              qf, interpret=True)
    got = fused_node_rhs.rhs_fused_node(tcfg, tconst, torch.tensor(q),
                                        torch.tensor(psi),
                                        torch.tensor(np.asarray(qf)))
    _close(got, want)


def test_x_varying_s2_runs_the_torch_ops():
    """An N2 field makes S2 vary in x: no profile for the kernel, and rhs_pv
    runs the plain version (on either device) where the JAX package runs
    its XLA lowering."""
    kw = _kw(N=32)
    jcfg, tcfg = jqn.NodeQGConfig(**kw), tqn.NodeQGConfig(**kw)
    N2 = 1.0 + 0.5 * np.random.default_rng(2).uniform(0, 1, (2, 33, 33))
    jconst = jqn.build_constants(jcfg, N2=N2)
    tconst = tqn.build_constants(tcfg, N2=N2, device="cpu")
    assert jconst.nrhsk is None and tconst.S2_prof is None
    assert tconst.nspec is None and tconst.vlevels is not None
    psi = np.asarray(jvertex.bc_psi(jnp.asarray(
        0.01 * np.random.default_rng(5).standard_normal((3, 33, 33)))))
    q = np.asarray(jqn.comp_q(jcfg, jconst, jnp.asarray(psi)))
    want = jqn.rhs_pv(jcfg, jconst, jnp.asarray(q), jnp.asarray(psi),
                      jnp.asarray(T_EVAL))
    got = tqn.rhs_pv(tcfg, tconst, torch.tensor(q), torch.tensor(psi),
                     torch.tensor(T_EVAL, dtype=torch.float64))
    _close(got, want)


def test_bound_work_at_the_node_path():
    """Bytes of the bench configuration at 2048^2 x 4 in f32: psi and the
    mask read, dq written, the profiles; some 90 operations a node and
    layer, so that the bytes bound it."""
    kw = dict(N=2048, nl=4, L0=100.0, f0=46.5, beta=0.5, hEkb=1e-3,
              tau0=1e-3, nu=5.0 / 32, dh=(0.25,) * 4, N2=(1.0,) * 3,
              bc_fac=1.0)
    cfg = tqn.NodeQGConfig(**kw)

    class Const:
        has_pg = has_topo = False
        q_forcing_3d = None

    nbytes, nops = fused_node_rhs.bound_work(cfg, Const, 4)
    assert nbytes == (9 * 2049 ** 2 + 4 * 2049) * 4
    assert 60 * 4 * 2049 ** 2 < nops < 200 * 4 * 2049 ** 2
    assert nops / 67e12 < nbytes / 3.35e12


def test_cpu_wrapper_never_builds_a_kernel(monkeypatch):
    """On a CPU tensor the wrapper does not reach the build."""
    from msom_tpu_torch import _build
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(name))
    jcfg, jconst, tcfg, tconst, q, psi = _setup("barotropic")
    qf = tqn.q_forcing_profile(tcfg, tconst.yv[:, 0],
                               torch.tensor(0.0, dtype=torch.float64))
    dq = fused_node_rhs.rhs_fused_node(tcfg, tconst, torch.tensor(q),
                                       torch.tensor(psi), qf)
    assert torch.isfinite(dq).all()
