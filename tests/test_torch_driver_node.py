"""The port's qg-node driver (driver_node.py: run_node, NodeOutput) against
the JAX package's (msom_tpu.driver_node), in float64 on the CPU at
32^2 x 3; its I/O and command line are tests/test_torch_driver_node_io.py's.

run_node is run from one numpy psi0 to tend = 0.5 with dtout = 0.25,
dtdiag = 0.125 and dtflt = 0.25 (28 steps: three vars.nc records,
the diag header and four rows, two filter events), walled, with the
coastline mask and solver="vmg", periodic (bc_fac = -1), and stochastic at
amp_stoch = 0 (the draw does not enter). Tolerances: the final q, psi and
psi_f and the diag rows' values to 1e-11 of their maxima; every vars.nc
record within float32 rounding, 2^-23 of the file's max|value| (both
round values 1e-11 apart to float32, and one at a rounding boundary may
fall either way); the NetCDF bytes and the deck's arrays exactly."""

import os
import shutil

import numpy as np
import pytest
import torch

from msom_tpu import driver_node as jdn
from msom_tpu.io import netcdf as jnc
from msom_tpu.models import qg_node as jqn
from msom_tpu_torch import driver_node as tdn
from msom_tpu_torch.io import netcdf as tnc
from msom_tpu_torch.models import qg_node as tqn

torch.set_num_threads(1)

LIMIT = 1e-11
EVENTS = dict(tend=0.5, dtout=0.25, dtdiag=0.125, dtflt=0.25)
RUNS = {
    "walled": (dict(), False),
    "coastline": (dict(solver="vmg"), True),
    "periodic": (dict(bc_fac=-1.0), False),
    "stochastic": (dict(stochastic=True, amp_stoch=0.0, L_filt_stoch=20.0),
                   False),
}


def _kw(**kw):
    base = dict(N=32, nl=3, L0=100.0, f0=10.0, beta=0.1, hEkb=1e-3,
                tau0=1e-3, tau1=5e-4, tf1=2.0, tf2=3.0, dy_ws=0.3, nu=5.0,
                dh=(0.2, 0.3, 0.5), N2=(1.0, 2.0), noise_init=1e-3,
                bc_fac=1.0, DT=5e-2, CFL=0.2, TOLERANCE=1e-10,
                Lfmax=30.0, Lfmin=10.0, dtype="float64", use_pallas=False,
                **EVENTS)
    base.update(kw)
    return base


def _psi0(cfg, seed=21):
    n = cfg.N if cfg.periodic else cfg.N + 1
    rng = np.random.default_rng(seed)
    y = np.arange(n)[:, None] * cfg.delta
    return cfg.noise_init * (rng.uniform(-1, 1, (cfg.nl, n, n))
                             + np.sin(2 * np.pi * y / cfg.L0))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def f32_close(got, want):
    """Equal within float32 rounding of the larger field."""
    return np.abs(got - want).max() <= 2.0 ** -23 * np.abs(want).max()


class Recorder:
    """A NodeOutput that also keeps the diag rows' values and the times of
    the output events."""

    def __init__(self, base, *a, **kw):
        self.out = base(*a, **kw)
        self.rows, self.times = [], []

    def __getattr__(self, name):
        return getattr(self.out, name)

    def diag_row(self, t, ke, d_ke, f_ke):
        self.rows.append((t, ke, d_ke, f_ke))
        self.out.diag_row(t, ke, d_ke, f_ke)

    def write(self, t, **fields):
        self.times.append(t)
        self.out.write(t, **fields)


def inputs(run):
    return dict(mask=tqn.coastline_mask(32)) if RUNS[run][1] else {}


def run_both(tmp_path, run, **over):
    kw, _ = RUNS[run]
    kw = _kw(**kw, **over)
    jcfg, tcfg = jqn.NodeQGConfig(**kw), tqn.NodeQGConfig(**kw)
    psi0 = _psi0(tcfg)
    out = {}
    for name, dn, qn, cfg in (("jax", jdn, jqn, jcfg),
                              ("port", tdn, tqn, tcfg)):
        dev = {} if name == "jax" else {"device": "cpu"}
        const = qn.build_constants(cfg, **inputs(run), **dev)
        state = qn.init_state(cfg, const, psi0=psi0)
        rec = Recorder(dn.NodeOutput, cfg, str(tmp_path / name),
                       params_text="N = 32\n")
        logs = []
        hooks = dn.RunHooks(on_log=lambda *a: logs.append(a))
        state, _ = dn.run_node(cfg, const=const, state=state, hooks=hooks,
                               output=rec, restart=None)
        out[name] = state, rec, logs
    return out


def same_vars_nc(path_t, path_j, names=("psi", "q")):
    """The same records (times exactly, fields within float32 rounding);
    returns the port's fields and times."""
    ft, tt = tnc.read_nc(path_t, list(names), time_index=None)
    fj, tj = jnc.read_nc(path_j, list(names), time_index=None)
    np.testing.assert_array_equal(tt, tj)
    for name in names:
        assert ft[name].shape == fj[name].shape, name
        assert f32_close(ft[name], fj[name]), name
    return ft, tt


@pytest.mark.parametrize("run", list(RUNS))
def test_run_node_matches_jax(tmp_path, run):
    out = run_both(tmp_path, run)
    (js, jrec, jlog), (ts, trec, tlog) = out["jax"], out["port"]
    for name in ("q", "psi", "psi_f"):
        r = _rel(getattr(ts, name).numpy(), getattr(js, name))
        assert r < LIMIT, f"{name}: {r:.3e}"
    assert int(ts.i) == int(js.i) and 20 <= int(ts.i) <= 40
    assert int(ts.nbar) == int(js.nbar) == 1
    assert float(ts.t) == pytest.approx(0.5, abs=1e-12)
    assert len(tlog) == len(jlog) == int(ts.i)
    for (ti, tdt, tt, tke), (ji, jdt, jt, jke) in zip(tlog, jlog):
        assert ti == ji and abs(tdt - jdt) <= 1e-12 * jdt
        assert abs(tke - jke) <= LIMIT * abs(jke), f"KE at step {ti}"
    # the diag rows: the values at 1e-11, the files' numbers to their
    # seven printed digits
    assert len(trec.rows) == len(jrec.rows) == 4
    tr, jr = np.array(trec.rows), np.array(jrec.rows)
    np.testing.assert_allclose(tr[:, 0], [0.125, 0.25, 0.375, 0.5],
                               atol=1e-12)
    for k in range(1, 4):
        assert _rel(tr[:, k], jr[:, k]) < LIMIT, f"diag column {k}"
    dat = [(tmp_path / n / "diag_1d.dat").read_text().splitlines()
           for n in ("port", "jax")]
    assert dat[0][0] == dat[1][0] == "# time, ke, dissipation, forcing"
    vals = [np.array([[float(v) for v in l.split(",")] for l in d[1:]])
            for d in dat]
    np.testing.assert_allclose(vals[0], vals[1], rtol=5e-7, atol=0)
    assert trec.times == jrec.times == [0.0, 0.25, 0.5]
    fields, times = same_vars_nc(str(tmp_path / "port" / "vars.nc"),
                                 str(tmp_path / "jax" / "vars.nc"))
    assert fields["psi"].shape == (3, 3, 33, 33)
    # the first record is the initial q (periodic: its vertex view)
    tcfg = tqn.NodeQGConfig(**_kw(**RUNS[run][0]))
    q0 = tqn.init_state(tcfg, tqn.build_constants(tcfg, device="cpu",
                                                  **inputs(run)),
                        psi0=_psi0(tcfg)).q
    np.testing.assert_array_equal(
        fields["q"][0], tqn.to_vertex_full(tcfg, q0).to(torch.float32)
        .double().numpy())
    assert (tmp_path / "port" / "params.in").read_text() == "N = 32\n"
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))


def test_restart_continues_the_trajectory(tmp_path):
    """The first half's vars.nc as restart.nc: the port's continued run
    agrees with the JAX one from the same file to 1e-11 and backs the file
    up; against the uninterrupted run it drifts by the float32 rounding of
    the stored psi and the reset CFL smoothing (the reference's static
    `previous` is lost on a restart too, qg-node/qg.h:259), so it is held,
    as tests/test_drivers_node.py holds the JAX restart, within 5% of the
    signal."""
    kw = _kw(tend=0.25, dtflt=-1.0)
    tcfg = tqn.NodeQGConfig(**kw)
    tc = tqn.build_constants(tcfg, device="cpu")
    psi0 = _psi0(tcfg)
    tdn.run_node(tcfg, const=tc, state=tqn.init_state(tcfg, tc, psi0=psi0),
                 outdir=str(tmp_path / "a"), restart=None)
    rp = str(tmp_path / "restart.nc")
    shutil.copy(tmp_path / "a" / "vars.nc", rp)
    full = _kw(tend=0.5, dtflt=-1.0)
    jcfg, tcfg2 = jqn.NodeQGConfig(**full), tqn.NodeQGConfig(**full)
    jc = jqn.build_constants(jcfg)
    js, _ = jdn.run_node(jcfg, const=jc, state=jqn.init_state(
        jcfg, jc, psi0=psi0), outdir=str(tmp_path / "j"), restart=rp)
    ts, _ = tdn.run_node(tcfg2, const=tc, state=tqn.init_state(
        tcfg2, tc, psi0=psi0), outdir=str(tmp_path / "b"), restart=rp)
    assert float(ts.t) == pytest.approx(0.5, abs=1e-12)
    assert int(ts.i) == int(js.i)
    for name in ("q", "psi"):
        assert _rel(getattr(ts, name).numpy(), getattr(js, name)) < LIMIT
    assert (tmp_path / "b" / "restart.nc.bak").read_bytes() == \
        open(rp, "rb").read()
    whole, _ = tdn.run_node(tcfg2, const=tc, state=tqn.init_state(
        tcfg2, tc, psi0=psi0), outdir=str(tmp_path / "c"), restart=None)
    drift = _rel(ts.q.numpy(), whole.q.numpy())
    assert 0 < drift < 0.05


def test_periodic_restart_drops_the_wrapped_copy(tmp_path):
    kw = _kw(bc_fac=-1.0, tend=0.125, dtout=0.125, dtflt=-1.0, dtdiag=-1.0)
    tcfg = tqn.NodeQGConfig(**kw)
    tc = tqn.build_constants(tcfg, device="cpu")
    st, _ = tdn.run_node(tcfg, const=tc, state=tqn.init_state(
        tcfg, tc, psi0=_psi0(tcfg)), outdir=str(tmp_path / "a"),
        restart=None)
    rp = str(tmp_path / "a" / "vars.nc")
    back, _ = tdn.run_node(tqn.NodeQGConfig(**dict(kw, tend=0.125)),
                           const=tc, outdir=str(tmp_path / "b"), restart=rp)
    assert back.psi.shape == (3, 32, 32) and int(back.i) == 0
    np.testing.assert_array_equal(
        back.psi.numpy(), st.psi.to(torch.float32).double().numpy())
