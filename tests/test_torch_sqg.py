"""The port's SQG variant (models/sqg.py) against the JAX package's
(msom_tpu.models.sqg), float64 on the CPU at 32^2 x 3.

Tolerances: the metrics exactly, S2 to 1e-15 of its maximum; comp_q,
rhs_bs and the bs source to 1e-13 of their maxima (the same stencils);
invert_q to 1e-11 of max|psi| with the same V-cycles (tolerance 1e-10);
10 steps to 1e-11 of max|q|, max|bs| and max|psi| with the same V-cycles
every step, with and without a large-scale flow and topography. bs = 0
reduces to the node model's baroclinic path exactly (the same
operations)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msom_tpu.models import qg_node as jnode
from msom_tpu.models import sqg as jsqg
from msom_tpu_torch import convert
from msom_tpu_torch.models import fused_node_rhs
from msom_tpu_torch.models import qg_node as tnode
from msom_tpu_torch.models import sqg as tsqg

torch.set_num_threads(1)

N, NL = 32, 3


def rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def configs(**kw):
    base = dict(N=N, nl=NL, L0=1.0, f0=1.0, beta=0.5, hEkb=1e-3, nu=1e-4,
                nu4=1e-9, tau0=1e-3, noise_init=1e-2, dh=(0.2, 0.3, 0.5),
                N2=(1.0, 0.5, 0.25), DT=1e-3, CFL=0.4, TOLERANCE=1e-10,
                flag_ms=1, dtype="float64", use_pallas=False)
    base.update(kw)
    return jnode.NodeQGConfig(**base), tnode.NodeQGConfig(**base)


def inputs(coupled):
    if not coupled:
        return {}
    rng = np.random.default_rng(8)
    y = np.arange(N + 1) / N
    gyre = np.sin(np.pi * y)
    return dict(psi_pg=1e-2 * gyre[None, :, None] * gyre[None, None, :]
                * np.array([1.0, 0.4, 0.1])[:, None, None],
                topo=0.1 * rng.uniform(-1, 1, (N + 1, N + 1)))


def ic(seed=3):
    rng = np.random.default_rng(seed)
    psi = 1e-2 * rng.uniform(-1, 1, (NL, N + 1, N + 1))
    bs = 1e-2 * rng.uniform(-1, 1, (N + 1, N + 1))
    bs[0] = bs[-1] = bs[:, 0] = bs[:, -1] = 0.0
    return psi, bs


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = configs()
    return (jcfg, tcfg, jsqg.build_constants(jcfg),
            tsqg.build_constants(tcfg, device="cpu"))


def test_metrics_and_constants(pair):
    jcfg, tcfg, jc, tc = pair
    for a, b in zip(tsqg.sqg_metrics((0.2, 0.3, 0.5)),
                    jsqg.sqg_metrics((0.2, 0.3, 0.5))):
        np.testing.assert_array_equal(a, b)
    assert tc.idh0 == jc.idh0 and tc.idh1 == jc.idh1
    assert rel(tc.S2, jc.S2) < 1e-15 and rel(tc.mask, jc.mask) == 0
    assert len(tc.vlevels) == len(jc.vlevels) == 5
    with pytest.raises(ValueError, match="nl >= 2"):
        tsqg.build_constants(configs(nl=1, dh=(1.0,))[1], device="cpu")


def test_comp_q_invert_and_rhs_bs(pair):
    jcfg, tcfg, jc, tc = pair
    psi, bs = ic()
    jpsi, jbs = jnode.vertex.bc_psi(jnp.asarray(psi)), jnp.asarray(bs)
    tpsi = tnode.vertex.bc_psi(torch.as_tensor(psi))
    tbs = torch.as_tensor(bs)
    jq = jsqg.comp_q(jcfg, jc, jpsi, jbs)
    tq = tsqg.comp_q(tcfg, tc, tpsi, tbs)
    assert rel(tq, jq) < 1e-13
    assert rel(tsqg.bs_source(tcfg, tc, tbs),
               jsqg.bs_source(jcfg, jc, jbs)) < 1e-15
    assert rel(tsqg.rhs_bs(tcfg, tc, tpsi, tbs),
               jsqg.rhs_bs(jcfg, jc, jpsi, jbs)) < 1e-13
    guess = torch.zeros_like(tpsi)
    p2, st = tsqg.invert_q(tcfg, tc, guess, tq, tbs)
    jp2, jst = jsqg.invert_q(jcfg, jc, jnp.zeros_like(jpsi), jq, jbs)
    assert st.iters == int(jst.iters) and rel(p2, jp2) < 1e-11
    assert rel(p2, tpsi) < 1e-8           # the inversion undoes comp_q


def test_bs_zero_reduces_to_the_node_path(pair):
    jcfg, tcfg, jc, tc = pair
    psi, _ = ic()
    tpsi = tnode.vertex.bc_psi(torch.as_tensor(psi))
    zero = torch.zeros((N + 1, N + 1), dtype=torch.float64)
    nc = tsqg._node_const(tcfg, tc)
    assert nc.nspec is None and nc.S2_prof is None
    q = tsqg.comp_q(tcfg, tc, tpsi, zero)
    assert torch.equal(q, tnode.comp_q(tcfg, nc, tpsi))
    t = torch.zeros((), dtype=torch.float64)
    before = fused_node_rhs.launches
    dq = tnode.rhs_pv(tcfg, nc, q, tpsi, t)
    assert fused_node_rhs.launches == before     # torch ops, not K5
    jnc = jsqg._node_const(jcfg, jc)
    jdq = jnode.rhs_pv(jcfg, jnc, jnp.asarray(q.numpy()),
                       jnp.asarray(tpsi.numpy()), jnp.asarray(0.0))
    assert rel(dq, jdq) < 1e-13


@pytest.mark.parametrize("coupled", [False, True])
def test_step_matches_jax(coupled):
    jcfg, tcfg = configs()
    fields = inputs(coupled)
    jc = jsqg.build_constants(jcfg, **fields)
    tc = tsqg.build_constants(tcfg, device="cpu", **fields)
    assert tc.has_pg == tc.has_topo == coupled
    psi, bs = ic()
    js = jsqg.init_state(jcfg, jc, psi0=psi, bs0=bs)
    ts = tsqg.init_state(tcfg, tc, psi0=psi, bs0=bs)
    jstep, tstep = jax.jit(jsqg.make_step(jcfg)), tsqg.make_step(tcfg)
    for i in range(10):
        js, jd = jstep(js, jc, jnp.asarray(1e18))
        ts, td = tstep(ts, tc, 1e18)
        assert td.mg_iters == int(jd.mg_iters), f"step {i}"
    for name in ("q", "bs", "psi"):
        assert rel(getattr(ts, name), getattr(js, name)) < 1e-11, name
    assert float(td.bs2) == pytest.approx(float(jd.bs2), rel=1e-11)
    assert float(ts.t) == pytest.approx(float(js.t), rel=1e-12)
    leaves = {k: np.asarray(getattr(js, k)) for k in convert.SQG_LEAVES}
    back = convert.sqg_state_to_numpy(
        convert.sqg_state_from_numpy(tcfg, leaves, device="cpu"))
    for k in convert.SQG_LEAVES:
        np.testing.assert_array_equal(back[k], leaves[k])
