"""The y-profile direct solve (solvers/vary.py) and varRo in the port
against the JAX package, float64 on the CPU.

Tolerances: the stretching blocks and the block-Thomas inverses W, both
formed on the host in f64 by the same arithmetic, to 1e-12; a solve by
each method ("scan": the sweep's plain version, the row loop that kernel
KV replaces on the card; "blocked"; "assoc") to 1e-11 of max|psi| against
the JAX "scan" (another summation order, rounding only); the folded x
transform in float32 at N = 512 to 1e-5 of max|psi| (f32 rounding of the
fold's matmuls and of 1024 dependent rows); the varRo step over 10 steps
(spectral, mg with the same V-cycles every step, mode_pv_invert, an
x-constant frpg with spectral) to 1e-11 of max|q| and max|psi|. The mg
steps' residuals are at roundoff, so they are held in absolute terms
(1e-9) rather than relative to each other."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msom_tpu.models import qg as jqg
from msom_tpu.params import QGConfig as JConfig
from msom_tpu.solvers import vary as jvary
from msom_tpu_torch.models import qg as tqg
from msom_tpu_torch.ops.stretch import layer_metrics
from msom_tpu_torch.params import QGConfig as TConfig
from msom_tpu_torch.solvers import fused_vary
from msom_tpu_torch.solvers import vary as tvary

torch.set_num_threads(1)


def rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def problem(N, nl, seed=0):
    """A y-profile of strl (varRo-like, rising with y), layer metrics and a
    rough right-hand side q."""
    rng = np.random.default_rng(seed + 10 * N + nl)
    y = (np.arange(N) + 0.5) / N
    s_prof = np.stack([(0.5 + 0.3 * l) * (1.0 + 0.6 * y) ** 2
                       + 0.05 * rng.uniform(size=N) for l in range(nl - 1)])
    _, idh0, idh1 = layer_metrics(rng.uniform(0.2, 1.0, nl))
    q = rng.standard_normal((nl, N, N))
    return s_prof, idh0, idh1, q


def build_both(N, nl, dtype, L0=80.0):
    s_prof, idh0, idh1, q = problem(N, nl)
    jd = jvary.build_spectral_vary(nl=nl, N=N, L0=L0, s_prof=s_prof,
                                   idh0=idh0, idh1=idh1, dtype=dtype)
    td = tvary.build_spectral_vary(nl=nl, N=N, L0=L0, s_prof=s_prof,
                                   idh0=idh0, idh1=idh1,
                                   dtype=getattr(torch, dtype),
                                   device="cpu")
    return jd, td, q


@functools.cache
def jax_scan(N, nl):
    jd, td, q = build_both(N, nl, "float64")
    psi = jvary.solve_spectral_vary(jd, jnp.asarray(q), method="scan")
    return np.asarray(psi), td, q


def test_gamma_blocks_and_factors():
    s_prof, idh0, idh1, _ = problem(32, 4)
    np.testing.assert_array_equal(tvary._gamma_blocks(s_prof, idh0, idh1),
                                  jvary._gamma_blocks(s_prof, idh0, idh1))
    jd, td, _ = build_both(32, 4, "float64")
    assert td.W.shape == (4, 4, 32, 32) and td.fac is None
    assert rel(td.W, jd.W) < 1e-12 and td.a == jd.a
    assert rel(td.S, jd.S) < 1e-15


@pytest.mark.parametrize("method", ["scan", "blocked", "assoc"])
@pytest.mark.parametrize("N,nl", [(32, 2), (64, 3), (32, 4)])
def test_solve_matches_jax_scan(N, nl, method):
    want, td, q = jax_scan(N, nl)
    before = fused_vary.launches
    got = tvary.solve_spectral_vary(td, torch.as_tensor(q), method=method)
    assert fused_vary.launches == before          # a CPU tensor: no kernel
    assert rel(got, want) < 1e-11


def test_solve_inverts_the_operator():
    """The solve is exact: the port's msqg operator (lap + Gamma with the
    y-varying strl) applied to psi gives q back to roundoff."""
    from msom_tpu_torch.ops.bc import BC
    from msom_tpu_torch.ops.ghost import ghosted, laplacian_g
    from msom_tpu_torch.ops.stretch import stretch
    N, nl, L0 = 32, 3, 80.0
    s_prof, idh0, idh1, q = problem(N, nl)
    td = tvary.build_spectral_vary(nl=nl, N=N, L0=L0, s_prof=s_prof,
                                   idh0=idh0, idh1=idh1,
                                   dtype=torch.float64, device="cpu")
    psi = tvary.solve_spectral_vary(td, torch.as_tensor(q))
    s = torch.as_tensor(s_prof)[..., None]
    Lpsi = laplacian_g(ghosted(psi, BC.DIRICHLET), L0 / N) \
        + stretch(psi, s, idh0, idh1)
    assert rel(Lpsi, q) < 1e-11


def test_fold_branch_float32():
    """f32 at N = 512: the folded x transform (lam permuted at build)
    against the JAX package's folded solve."""
    N, nl = 512, 2
    jd, td, q = build_both(N, nl, "float32")
    assert td.fac is not None and jd.fac is not None and td.S is None
    assert rel(td.W, jd.W) < 1e-6
    want = np.asarray(jvary.solve_spectral_vary(
        jd, jnp.asarray(q, jnp.float32), method="scan"))
    got = tvary.solve_spectral_vary(td, torch.as_tensor(q,
                                                        dtype=torch.float32))
    assert got.dtype == torch.float32 and rel(got, want) < 1e-5


def test_applicable():
    y = np.linspace(1, 2, 8)
    prof = np.broadcast_to(y[None, :, None], (2, 8, 8))
    assert tvary.applicable(prof) == jvary.applicable(prof) is True
    assert tvary.applicable(prof[..., :1])
    assert not tvary.applicable(np.ones((2, 8, 8)))
    assert not tvary.applicable(prof + np.arange(8)[None, None, :])
    assert not tvary.applicable(None)


def test_sweep_reference_is_the_scan():
    """The plain version of KV on (W, X) against the JAX scan's two
    sweeps, fed the same transformed right-hand side."""
    N, nl = 32, 3
    jd, td, q = build_both(N, nl, "float64")
    X = np.asarray(torch.matmul(torch.as_tensor(q), td.S.T))
    got = fused_vary.sweep(td.W, torch.as_tensor(X), td.a)
    # the JAX solve minus its inverse transform: psi = S^T Psi
    psi = np.asarray(jvary.solve_spectral_vary(jd, jnp.asarray(q),
                                               method="scan"))
    assert rel(got, psi @ np.asarray(jd.S).T) < 1e-11
    nbytes, nops = fused_vary.bound_work(4, 2048, 2048, 4)
    assert nbytes == 805306368 and nops > 0


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("nl", range(2, 9))
def test_kv_geometry_fits(nl, itemsize):
    """KV's launch geometry for every N, Kx in {1, 3, 100, 257, 2048}: the
    grid covers every column, the shared memory fits a block's 232,448 B,
    TMA is chosen exactly where the global strides are 16-byte aligned,
    the ring holds at least one stage, and the consumer threads are whole
    warps of whole columns."""
    sizes = (1, 3, 100, 257, 2048)
    for N in sizes:
        for K in sizes:
            g = fused_vary.geometry(nl, N, K, itemsize)
            assert g.grid * g.cols >= K > (g.grid - 1) * g.cols
            assert g.smem == fused_vary.smem_bytes(nl, itemsize, g.cols,
                                                   g.rows, g.stages)
            assert g.smem <= 232448 == fused_vary.MAX_SMEM
            assert g.tma == ((K * itemsize) % 16 == 0)
            assert 1 <= g.stages <= fused_vary.MAX_STAGES
            assert g.rows == fused_vary.rows_for(nl, itemsize) >= 1
            assert g.smem >= fused_vary.stage_bytes(nl, itemsize, g.cols,
                                                    g.rows) * g.stages
            assert g.lanes == fused_vary.lanes_for(nl) >= nl
            assert 32 % g.lanes == 0 and g.cols == fused_vary.cols_for(nl)
            assert (g.cols * g.lanes) % 32 == 0
            assert g.threads == g.cols * g.lanes + 32 <= 384
            if g.tma:
                assert (g.cols * itemsize) % 16 == 0
            assert not fused_vary.geometry(nl, N, K, itemsize,
                                           aligned=False).tma


# ---------------------------------------------------------------------------
# varRo and the y-profile frpg through the msqg step
# ---------------------------------------------------------------------------

N = 32
VARRO = dict(N=N, nl=3, L0=80, Rom=0.025, Ekb=0.002, tau0=1e-4, Re4=1563,
             beta=0.5, varRo=1, Fr=(0.0023669, 0.0076173),
             dh=(0.06, 0.14, 0.8), DT=5e-2, tend=1e18, dtout=1e18, CFL=0.6,
             dtype="float64")


def frpg_y():
    y = (np.arange(N) + 0.5) / N
    Y = np.broadcast_to(y[:, None], (N, N))
    return np.stack([0.0023669 * (1 + 0.4 * Y), 0.0076173 * (1 - 0.3 * Y)])


@pytest.mark.parametrize("label,over", [
    ("spectral", dict(solver="spectral")),
    ("mg", dict(solver="mg", tol=1e-8)),
    ("mode_pv_invert", dict(solver="mg", tol=1e-8, mode_pv_invert=True)),
    ("frpg spectral", dict(solver="spectral", varRo=0)),
])
def test_varro_step_matches_jax(label, over):
    kw = dict(VARRO, **over)
    jcfg, tcfg = JConfig(**kw).validate(), TConfig(**kw).validate()
    fields = dict(frpg=frpg_y()) if label.startswith("frpg") else {}
    jc = jqg.build_constants(jcfg, **fields)
    tc = tqg.build_constants(tcfg, device="cpu", **fields)
    assert tc.rhs_kernel
    assert rel(tc.strl.expand(2, N, N), jc.strl) == 0
    if label != "frpg spectral":
        assert rel(tc.Ro.expand(N, N), jc.Ro) < 1e-15
    if tcfg.solver == "spectral":
        assert isinstance(tc.spec, tvary.VarySpectralData)
        assert isinstance(jc.spec, jvary.VarySpectralData)
    else:
        levels = tc.mlevels if tcfg.mode_pv_invert else tc.levels
        assert all(lvl.sw is not None for lvl in levels)   # K3/K4 route
    psi0 = 1e-3 * np.random.default_rng(1).uniform(-1, 1, (3, N, N))
    js = jqg.init_state(jcfg, jc, psi0=psi0)
    ts = tqg.init_state(tcfg, tc, psi0=psi0)
    jstep, tstep = jax.jit(jqg.make_step(jcfg)), tqg.make_step(tcfg)
    for i in range(10):
        js, jd = jstep(js, jc, jnp.asarray(1e18))
        ts, td = tstep(ts, tc, 1e18)
        assert td.mg_iters == int(jd.mg_iters), f"step {i}"
        assert abs(td.mg_res - float(jd.mg_res)) < 1e-9
    assert rel(ts.q, js.q) < 1e-11 and rel(ts.psi, js.psi) < 1e-11
    assert float(ts.t) == pytest.approx(float(js.t), rel=1e-12)


def test_varro_topography_profile():
    """With topography the fused tendency reads 1/(Ro(y) dh_bottom)."""
    tcfg = TConfig(**dict(VARRO, solver="spectral")).validate()
    topo = np.random.default_rng(2).uniform(-1, 1, (N, N))
    tc = tqg.build_constants(tcfg, device="cpu", topo=topo)
    assert torch.allclose(tc.iro, 1.0 / (tc.Ro * tcfg.dh[2]), rtol=1e-15)
    assert float(tc.Ro[0, 0]) != float(tc.Ro[-1, 0])
