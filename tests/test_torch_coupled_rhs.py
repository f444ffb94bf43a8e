"""The port's fused tendency with its coupling options
(msom_tpu_torch.models.fused_rhs.rhs_fused_reference, the plain PyTorch
version that the CUDA kernel is held against on the card) against the JAX
package's Pallas kernel in interpret mode (pallas_rhs.rhs_fused) and its
XLA lowering (qg.rhs), on identical float64 inputs: the cases of
tests/test_pallas_rhs.py (PG coupling, _LS_RV, topography, qforc,
ENERGY_CONSERV, partial slip, everything at once, nl = 1 with pp and
topography), and the wall hazards the coupled kernel adds.

Tolerances are those of tests/test_pallas_rhs.py: dq at atol
1e-12 x max(|dq|, 1), the per-layer face-speed maxima at rtol 1e-12."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msom_tpu.models import pallas_rhs
from msom_tpu.models import qg as jqg
from msom_tpu.ops.ghost import ghosted, laplacian_g, max_face_speed_layers
from msom_tpu.params import QGConfig as JConfig
from msom_tpu_torch.models import fused_rhs
from msom_tpu_torch.models import qg as tqg
from msom_tpu_torch.params import QGConfig as TConfig

torch.set_num_threads(1)


def _configs(N=128, nl=3, **kw):
    base = dict(N=N, nl=nl, L0=80, Rom=0.025, Ekb=0.002, Eks=0.001,
                tau0=1e-4, Re4=391, beta=0.5,
                Fr=(0.0023669,) * (nl - 1), dh=tuple([1.0 / nl] * nl),
                DT=5e-2, tend=500.0, dtout=1.0, CFL=0.6, dtype="float64",
                solver="spectral")
    base.update(kw)
    return JConfig(**base).validate(), TConfig(**base).validate()


def _smooth(rng, shape, N):
    """A smooth random field: a few low modes plus noise."""
    x = (np.arange(N) + 0.5) / N
    X, Y = np.meshgrid(x, x, indexing="xy")
    out = np.zeros(shape)
    flat = out.reshape(-1, N, N)
    for k in range(flat.shape[0]):
        flat[k] = (np.sin(np.pi * (k % 3 + 1) * Y) * np.cos(np.pi * X)
                   + 0.3 * np.cos(2 * np.pi * X) * np.sin(2 * np.pi * Y))
    return out + 0.05 * rng.standard_normal(shape)


def _psi(shape, seed):
    rng = np.random.default_rng(seed)
    psi = 1e-3 * rng.uniform(-1, 1, shape) \
        + 0.1 * rng.standard_normal(shape)
    return psi - psi.mean(axis=(-2, -1), keepdims=True)


def _check(jcfg, tcfg, psi, **inputs):
    """The plain version against the Pallas kernel (interpret) and qg.rhs
    with the same input fields; returns the port's dq."""
    jc = jqg.build_constants(jcfg, **inputs)
    assert pallas_rhs.applicable(jcfg, jc)
    p = jnp.asarray(psi)
    jq = jqg.comp_q(jcfg, jc, p)
    need_q = jcfg.energy_conserv
    dq_k, umax_k = pallas_rhs.rhs_fused(jcfg, jc, p, jq if need_q else None,
                                        interpret=True)
    psi_g = ghosted(p, jqg._bc_psi(jcfg))
    zeta = laplacian_g(psi_g, jcfg.delta)
    dq_x, _ = jqg.rhs(jcfg, jc, jq, p, psi_g, zeta,
                      jqg._ghost_deriv(jcfg, zeta, psi_g), None)
    umax_x = max_face_speed_layers(psi_g, jcfg.delta)

    tc = tqg.build_constants(tcfg, device="cpu", **inputs)
    tp = torch.as_tensor(psi)
    tq = tqg.comp_q(tcfg, tc, tp)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0,
                               atol=1e-13 * np.abs(jq).max())
    dq, umax = fused_rhs.rhs_fused_reference(tcfg, tc, tp,
                                             tq if need_q else None)
    dq, umax = dq.numpy(), umax.numpy()
    assert dq.shape == psi.shape and umax.shape == (psi.shape[0],)
    for want in (np.asarray(dq_k), np.asarray(dq_x)):
        np.testing.assert_allclose(dq, want, rtol=0,
                                   atol=1e-12 * max(np.abs(want).max(), 1.0))
    for want in (umax_k, umax_x):
        np.testing.assert_allclose(umax, np.asarray(want), rtol=1e-12, atol=0)
    if jc.rhsk.umax_pp is not None:
        np.testing.assert_allclose(tc.umax_pp.numpy(),
                                   np.asarray(jc.rhsk.umax_pp), rtol=1e-12,
                                   atol=0)
    else:
        assert tc.umax_pp is None
    # the CPU route of the wrapper is this plain version
    dq_w, _ = fused_rhs.rhs_fused(tcfg, tc, tp, tq if need_q else None)
    assert torch.equal(dq_w, torch.as_tensor(dq))
    return dq


def _case(name):
    """(config overrides, input fields) of one case of
    tests/test_pallas_rhs.py:102-205; N = 128, nl = 3 unless overridden."""
    rng = np.random.default_rng(sum(map(ord, name)))
    N = 128
    pp = _smooth(rng, (3, N, N), N)
    topo = _smooth(rng, (N, N), N)
    qforc = 0.01 * rng.standard_normal((3, N, N))
    return {
        "pg": (dict(), dict(psipg=pp)),
        "pg_flsrv": (dict(flsrv=1), dict(psipg=pp)),
        "pg_from_upg_vpg": (dict(upg=(0.02, 0.01, 0.0),
                                 vpg=(0.01, -0.005, 0.0), flsrv=1), dict()),
        "topography": (dict(), dict(topo=topo)),
        "qforc": (dict(), dict(qforc=100 * qforc)),
        "energy_conserv": (dict(energy_conserv=True), dict()),
        "energy_conserv_pg": (dict(energy_conserv=True), dict(psipg=pp)),
        "partial_slip": (dict(sbc=1.0, Re=1000), dict()),
        "everything": (dict(flsrv=1, sbc=0.5, Re=2000),
                       dict(psipg=pp, topo=topo, qforc=qforc)),
        "nl1_pg_topo": (dict(N=64, nl=1, Fr=(), dh=(1.0,)),
                        dict(psipg=_smooth(rng, (1, 64, 64), 64),
                             topo=_smooth(rng, (64, 64), 64))),
        "dh_override": (dict(), dict(dh=(0.2, 0.3, 0.5))),
    }[name]


@pytest.mark.parametrize("name", [
    "pg", "pg_flsrv", "pg_from_upg_vpg", "topography", "qforc",
    "energy_conserv", "energy_conserv_pg", "partial_slip", "everything",
    "nl1_pg_topo", "dh_override"])
def test_coupled_rhs_matches_pallas_and_xla(name):
    over, inputs = _case(name)
    jcfg, tcfg = _configs(**over)
    _check(jcfg, tcfg, _psi((jcfg.nl, jcfg.N, jcfg.N), len(name)), **inputs)


def _corners(shape):
    f = np.zeros(shape)
    f[..., 0, 0] = f[..., -1, -1] = 1.0
    f[..., 0, -1] = f[..., -1, 0] = -1.0
    return f


def _ring(shape, seed, width=3):
    """Noise in the cells next to each wall, zero inside."""
    f = np.random.default_rng(seed).standard_normal(shape)
    f[..., width:-width, width:-width] = 0.0
    return f


@pytest.mark.parametrize("case", ["slip_corner", "slip_ring", "topo_corner",
                                  "zetap_ring", "pp_corner"])
def test_coupled_rhs_wall_hazards(case):
    """Where a tiled coupled kernel goes wrong, each held against the JAX
    kernel: the slip law overwrites the edge ghosts of zeta and of the
    biharmonic intermediate but leaves their corner ghosts at the Dirichlet
    fill; the topography's ghosts are Neumann, its corners +interior with
    no sign flip; zetap's ghost ring is the Dirichlet rule on zetap's own
    interior, not a Laplacian of pp's ghosts; pp's corner ghosts compose to
    +interior in the cascade's cross terms."""
    N, nl = 64, 3
    shape = (nl, N, N)
    rng = np.random.default_rng(11)
    over, inputs, psi = dict(Re=1000), {}, _ring(shape, 5)
    if case == "slip_corner":
        over.update(sbc=2.0)
        psi = _corners(shape) * np.array([1.0, -2.0, 0.5])[:, None, None]
    elif case == "slip_ring":
        over.update(sbc=0.3)
    elif case == "topo_corner":
        inputs["topo"] = _corners((N, N)) + 0.1 * _ring((N, N), 6, 1)
    elif case == "zetap_ring":
        over.update(flsrv=1)
        inputs["psipg"] = _ring(shape, 7, 2)
    else:
        inputs["psipg"] = _corners(shape) + 0.0 * rng.standard_normal(shape)
    jcfg, tcfg = _configs(N=N, nl=nl, **over)
    dq = _check(jcfg, tcfg, psi, **inputs)
    assert np.abs(dq).max() > 0


def test_slip_ghosts_differ_from_free_slip_only_near_walls():
    """sbc > 0 changes dq in the two cells next to a wall (zeta's ghosts
    reach the first cell through lap zeta and J, the intermediate's ghosts
    the first, and lap tmp the second) and nowhere inside."""
    _, free = _configs(N=32, Re=1000)
    _, slip = _configs(N=32, Re=1000, sbc=1.0)
    psi = torch.as_tensor(_psi((3, 32, 32), 4))
    dq = [fused_rhs.rhs_fused_reference(
        c, tqg.build_constants(c, device="cpu"), psi)[0] for c in (free, slip)]
    diff = (dq[1] - dq[0]).abs()
    assert diff[:, 2:-2, 2:-2].max() == 0
    assert diff[:, 0, :].max() > 0 and diff[:, :, -1].max() > 0


def test_energy_conserv_needs_q_and_nl1_ignores_pp():
    _, cfg = _configs(N=32, energy_conserv=True)
    const = tqg.build_constants(cfg, device="cpu")
    psi = torch.as_tensor(_psi((3, 32, 32), 1))
    with pytest.raises((ValueError, AttributeError, TypeError)):
        fused_rhs.rhs_fused_reference(cfg, const, psi, None)
    # nl == 1 skips the advection block, pp terms included, not topography
    rng = np.random.default_rng(3)
    _, c1 = _configs(N=32, nl=1, Fr=(), dh=(1.0,))
    psi1 = torch.as_tensor(_psi((1, 32, 32), 2))
    base = fused_rhs.rhs_fused_reference(
        c1, tqg.build_constants(c1, device="cpu"), psi1)[0]
    with_pp = fused_rhs.rhs_fused_reference(
        c1, tqg.build_constants(c1, device="cpu",
                                psipg=_smooth(rng, (1, 32, 32), 32)), psi1)[0]
    with_topo = fused_rhs.rhs_fused_reference(
        c1, tqg.build_constants(c1, device="cpu",
                                topo=_smooth(rng, (32, 32), 32)), psi1)[0]
    assert torch.equal(base, with_pp)
    assert not torch.equal(base, with_topo)


@pytest.mark.parametrize("name,shape", [("psipg", (3, 16, 8)),
                                        ("topo", (3, 16, 16)),
                                        ("qforc", (16, 16)),
                                        ("ptr_relax", (3, 1, 16, 16))])
def test_build_constants_checks_input_shapes(name, shape):
    _, cfg = _configs(N=16, nptr=2, Pe=(1e3, 2e3), ptr_r=(100.0, 0.0))
    with pytest.raises(ValueError, match=name):
        tqg.build_constants(cfg, device="cpu", **{name: np.zeros(shape)})


def test_bound_work_counts_the_coupling_fields():
    """The coupled bench configuration at 2048^2 x 4 f32 moves psi, pp and
    dq (4 planes each) and one topography plane: 13 planes of 16.8 MB."""
    import types
    _, cfg = _configs(N=2048, nl=4)
    plane = torch.empty(0)
    const = types.SimpleNamespace(pp=plane, zetap_pad=None, topo=plane,
                                  iro=plane, qforc=None)
    nbytes, nops = fused_rhs.bound_work(cfg, const, 4)
    want = 13 * 2048 ** 2 * 4
    assert want <= nbytes < want + 2 ** 17
    bare = types.SimpleNamespace(pp=None, zetap_pad=None, topo=None, iro=None,
                                 qforc=None)
    assert nops > fused_rhs.bound_work(cfg, bare, 4)[1]
