"""The port's wavelet transform and msqg filter event (ops/wavelet.py, the
filter constants of models/qg.py) against the JAX package on identical
float64 numpy inputs: the forward and inverse transforms and filter_field
under each ghost law, the sig_lev pyramid, the filter scale from rdpg and
from the modal deformation radius, and three filter events in a row
(walled and periodic, spectral and multigrid), which accumulate the
filter-mean PV flux qof and its count nbar.

Tolerances: the transforms and filter_field to 1e-13 of max|out| (the same
arithmetic; the port's 4-cell average is avg_pool2d, JAX's a
reduce_window, so sums may differ in the last bit); sig_lev_pyramid
exactly (the same numpy code); the events' q, psi and qof to 1e-12 of
their maxima (one inversion each, exact to roundoff in the spectral solve;
the mg solve takes the same cycles to its tolerance)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msom_tpu.models import qg as jqg
from msom_tpu.ops import wavelet as jwv
from msom_tpu.ops.bc import BC as JBC
from msom_tpu.params import QGConfig as JConfig
from msom_tpu_torch.models import qg as tqg
from msom_tpu_torch.ops import wavelet as twv
from msom_tpu_torch.ops.bc import BC as TBC
from msom_tpu_torch.params import QGConfig as TConfig

torch.set_num_threads(1)

BCS = [("dirichlet", JBC.DIRICHLET, TBC.DIRICHLET),
       ("neumann", JBC.NEUMANN, TBC.NEUMANN),
       ("periodic", JBC.PERIODIC, TBC.PERIODIC)]


def verron(N=64, **kw):
    """tests/test_lockstep.py's Verron deck with a filter every 0.25 and
    afilt = 7 (so a level of the pyramid sits on the ramp), both
    packages."""
    base = dict(N=N, nl=3, L0=80, Rom=0.025, Ekb=0.002, tau0=1e-4, Re4=1563,
                beta=0.5, Fr=(0.0023669, 0.0076173), dh=(0.06, 0.14, 0.8),
                DT=5e-2, tend=500., dtout=1., CFL=0.6, dtype="float64",
                solver="spectral", dtflt=0.25, afilt=7.0)
    base.update(kw)
    return JConfig(**base).validate(), TConfig(**base).validate()


def rel(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def rough(shape, seed):
    """A smooth gyre plus white noise, so that every level has detail."""
    rng = np.random.default_rng(seed)
    N = shape[-1]
    y = (np.arange(N) + 0.5) / N
    return (np.sin(np.pi * y)[:, None] * np.sin(2 * np.pi * y)[None, :]
            + 0.1 * rng.standard_normal(shape))


def rdpg_field(N):
    """A deformation radius varying across the basin, 0.75 to 1.25."""
    y = (np.arange(N) + 0.5) / N
    return 1.0 + 0.5 * np.sin(np.pi * y)[:, None] * np.cos(np.pi * y)[None, :]


@pytest.mark.parametrize("name,jbc,tbc", BCS, ids=[b[0] for b in BCS])
@pytest.mark.parametrize("shape", [(2, 32, 32), (3, 64, 64)])
def test_transforms_match_jax(name, jbc, tbc, shape):
    s = rough(shape, 1)
    jw = jwv.wavelet(jnp.asarray(s), jbc)
    tw = twv.wavelet(torch.as_tensor(s), tbc)
    assert [tuple(w.shape) for w in tw] == [w.shape for w in jw]
    for l, (a, b) in enumerate(zip(tw, jw)):
        assert rel(a, b) < 1e-13, f"level {l}"
    back = twv.inverse_wavelet(tw, tbc)
    assert rel(back, jwv.inverse_wavelet(jw, jbc)) < 1e-13
    assert rel(back, s) < 1e-13             # an exact round trip


@pytest.mark.parametrize("name,jbc,tbc", BCS, ids=[b[0] for b in BCS])
def test_filter_field_matches_jax(name, jbc, tbc):
    N, L0 = 64, 80.0
    sig = jwv.sig_lev_pyramid(7.0 * rdpg_field(N), L0)
    s = rough((3, N, N), 2)
    want = jwv.filter_field(jnp.asarray(s), sig, jbc)
    got = twv.filter_field(torch.as_tensor(s),
                           tuple(torch.as_tensor(x) for x in sig), tbc)
    assert rel(got, want) < 1e-13
    # the weights damp: the filtered field differs from the field
    assert rel(got, s) > 1e-3


@pytest.mark.parametrize("name,jbc,tbc", BCS, ids=[b[0] for b in BCS])
def test_masked_transforms_match_jax(name, jbc, tbc):
    """The mask_pyramid argument (qg-node's wavelet_mask, kept for the
    masked node filter): every level multiplied by its 0/1 mask."""
    N = 32
    s = rough((2, N, N), 12)
    mask = [np.ones((1, 1))]
    for l in range(1, 6):
        n = 2 ** l
        m = np.ones((n, n))
        m[: n // 4, : n // 2] = 0.0             # a corner of land
        mask.append(m)
    jw = jwv.wavelet(jnp.asarray(s), jbc, [jnp.asarray(m) for m in mask])
    tmask = [torch.as_tensor(m) for m in mask]
    tw = twv.wavelet(torch.as_tensor(s), tbc, tmask)
    for a, b in zip(tw, jw):
        assert np.abs(a.numpy() - np.asarray(b)).max() \
            <= 1e-13 * np.abs(np.asarray(b)).max()
    assert rel(twv.inverse_wavelet(tw, tbc, tmask),
               jwv.inverse_wavelet(jw, jbc,
                                   [jnp.asarray(m) for m in mask])) < 1e-13
    sig = tuple(torch.full((2 ** l, 2 ** l), 0.5, dtype=torch.float64)
                for l in range(6))
    got = twv.filter_field(torch.as_tensor(s), sig, tbc, tmask)
    want = jwv.filter_field(jnp.asarray(s), [np.full((2 ** l, 2 ** l), 0.5)
                                             for l in range(6)], jbc,
                            [jnp.asarray(m) for m in mask])
    assert rel(got, want) < 1e-13


@pytest.mark.parametrize("highpass", [True, False])
def test_sig_lev_pyramid_equals_jax(highpass):
    for N, sig_filt in ((64, 7.0 * rdpg_field(64)),
                        (128, np.full((128, 128), 10.0)),
                        (32, np.where(np.arange(32) < 16, 0.5, 100.0)
                         * np.ones((32, 32)))):
        got = twv.sig_lev_pyramid(sig_filt, 80.0, highpass)
        want = jwv.sig_lev_pyramid(sig_filt, 80.0, highpass)
        assert len(got) == len(want) == int(np.log2(N)) + 1
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["default", "rdpg", "mode_pv_invert",
                                  "mode_pv_invert_rdpg", "lfmax"])
def test_filter_scale_matches_jax(case):
    """sig_filt = min(afilt Rd, Lfmax) with Rd = 1, the rdpg input, or
    with mode_pv_invert the first baroclinic radius (which wins over
    rdpg); the pyramid built from it on the device, in the config's type."""
    kw = {"mode_pv_invert": True, "solver": "mg"} \
        if case.startswith("mode") else {}
    if case == "lfmax":
        kw["Lfmax"] = 8.0
    jcfg, tcfg = verron(64, **kw)
    inputs = {"rdpg": rdpg_field(64)} if "rdpg" in case or case == "lfmax" \
        else {}
    jc = jqg.build_constants(jcfg, **inputs)
    tc = tqg.build_constants(tcfg, device="cpu", **inputs)
    np.testing.assert_array_equal(tc.Rd.numpy(), np.asarray(jc.Rd))
    np.testing.assert_array_equal(tc.sig_filt.numpy(),
                                  np.asarray(jc.sig_filt))
    assert len(tc.sig_lev) == len(jc.sig_lev) == 7
    for a, b in zip(tc.sig_lev, jc.sig_lev):
        assert a.dtype == torch.float64
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="rdpg"):
        tqg.build_constants(tcfg, device="cpu", rdpg=np.ones((8, 8)))


def test_filter_weights_need_the_filter_and_a_power_of_two():
    """Without the filter (dtflt <= 0) no pyramid is built, so any N
    builds (the kernels' checks use N = 100, 130, 257); with it N must be
    a power of 2."""
    _, tcfg = verron(100, dtflt=-1.0)
    const = tqg.build_constants(tcfg, device="cpu")
    assert const.sig_lev is None and tuple(const.sig_filt.shape) == (100, 100)
    with pytest.raises(ValueError, match="power of 2"):
        tqg.build_constants(dataclasses.replace(tcfg, dtflt=0.25),
                            device="cpu")


FILTER_CASES = {
    "walled spectral": dict(),
    "walled mg": dict(solver="mg"),
    "periodic spectral": dict(sbc=-1.0),
    "periodic mg": dict(sbc=-1.0, solver="mg"),
    "partial slip spectral": dict(sbc=1.0),
}


@pytest.mark.parametrize("case", list(FILTER_CASES))
def test_three_filter_events_match_jax(case):
    """Three wavelet_filter_step events in a row, each after two steps, on
    both sides from one numpy psi0 and one rdpg: q, psi, qof and nbar
    agree after each event."""
    jcfg, tcfg = verron(64, **FILTER_CASES[case])
    rng = np.random.default_rng(5)
    psi0 = 1e-2 * rough((3, 64, 64), 6) + 1e-3 * rng.uniform(-1, 1,
                                                             (3, 64, 64))
    rd = rdpg_field(64)
    jc = jqg.build_constants(jcfg, rdpg=rd)
    js = jqg.init_state(jcfg, jc, psi0=psi0)
    tc = tqg.build_constants(tcfg, device="cpu", rdpg=rd)
    ts = tqg.init_state(tcfg, tc, psi0=psi0)
    assert int(ts.nbar) == 0 and float(ts.qof.abs().max()) == 0.0
    jstep, tstep = jqg.make_step(jcfg), tqg.make_step(tcfg)
    for event in range(1, 4):
        for _ in range(2):
            js, _ = jstep(js, jc, jnp.asarray(1e9))
            ts, _ = tstep(ts, tc, 1e9)
        js = jwv.wavelet_filter_step(jcfg, jc, js)
        ts = twv.wavelet_filter_step(tcfg, tc, ts)
        assert int(ts.nbar) == int(js.nbar) == event
        assert ts.nbar.dtype == torch.int32
        for name in ("q", "psi", "qof"):
            r = rel(getattr(ts, name), getattr(js, name))
            assert r < 1e-12, f"event {event}: {name} {r:.3e}"
    # the filter changed the state: qof is the mean of nonzero fluxes
    assert float(ts.qof.abs().max()) > 0


def test_filter_event_without_a_mean_starts_one():
    """A state built without a filter (qof, nbar None) gets both at its
    first event, as in JAX."""
    jcfg, tcfg = verron(32)
    psi0 = 1e-3 * rough((3, 32, 32), 7)
    nofilt = dataclasses.replace(tcfg, dtflt=-1.0)
    tc = tqg.build_constants(tcfg, device="cpu")
    ts = tqg.init_state(nofilt, tc, psi0=psi0)
    assert ts.qof is None and ts.nbar is None
    out = twv.wavelet_filter_step(tcfg, tc, ts)
    jc = jqg.build_constants(jcfg)
    js = jqg.init_state(dataclasses.replace(jcfg, dtflt=-1.0), jc, psi0=psi0)
    want = jwv.wavelet_filter_step(jcfg, jc, js)
    assert int(out.nbar) == 1
    assert rel(out.qof, want.qof) < 1e-12
