"""The port's newqg and SQG drivers (driver_node.run_newqg, run_sqg and
`--model newqg|sqg`) against the JAX package's (msom_tpu.driver_node),
float64 on the CPU, and the float32 event-time fault of the JAX drivers.

Both packages start each run from one restart.nc (the float32 case from
one numpy psi), so they compute the same thing. Tolerances: the final
fields to 1e-11 of their maxima; every vars.nc record within float32
rounding, 2^-23 of the file's max|value| (both round values 1e-11 apart
to float32, and one at a rounding boundary may fall either way); the
record times to 1e-12."""

import os

import numpy as np
import pytest
import torch

from msom_tpu import driver_node as jdn
from msom_tpu.io import netcdf as jnc
from msom_tpu.models import newqg as jnq
from msom_tpu.models import qg_node as jnode
from msom_tpu_torch import driver_node as tdn
from msom_tpu_torch.io import netcdf as tnc
from msom_tpu_torch.models import newqg as tnq
from msom_tpu_torch.models import qg_node as tnode

torch.set_num_threads(1)

LIMIT = 1e-11
NEWQG = dict(N=32, nl=1, L0=1.0, f0=10.0, beta=2.0, hEkb=1e-3, tau0=1e-3,
             nu=1e-5, gp_low=0.1, dh=(1.0,), DT=1e-2, tend=0.1, dtout=0.05,
             CFL=0.5, TOLERANCE=1e-8, dtype="float64")
SQG = dict(N=16, nl=2, L0=1.0, f0=5.0, beta=0.1, nu=1e-4, dh=(0.5, 0.5),
           N2=(1.0, 1.0), noise_init=1e-2, DT=5e-3, tend=0.05, dtout=0.025,
           CFL=0.4, TOLERANCE=1e-8, dtype="float64")
NEWQG_DECK = "\n".join(f"{k} = {list(v) if isinstance(v, tuple) else v}"
                       for k, v in NEWQG.items())
SQG_DECK = "\n".join(f"{k} = {list(v) if isinstance(v, tuple) else v}"
                     for k, v in SQG.items())


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _f32_close(got, want):
    return np.abs(got - want).max() <= 2.0 ** -23 * np.abs(want).max()


def _files_agree(port_dir, jax_dir, names):
    f_t, t_t = tnc.read_nc(os.path.join(port_dir, "vars.nc"), names, None)
    f_j, t_j = tnc.read_nc(os.path.join(jax_dir, "vars.nc"), names, None)
    assert np.allclose(t_t, t_j, rtol=1e-12, atol=0)
    for name in names:
        assert f_t[name].shape == f_j[name].shape, name
        assert _f32_close(f_t[name], f_j[name]), name
    return t_t


def _psi0(nl, n, seed=7):
    rng = np.random.default_rng(seed)
    y = np.arange(n)[:, None] / n
    return 1e-2 * (rng.uniform(-1, 1, (nl, n, n)) + np.sin(2 * np.pi * y))


def _restart_file(path, names, fields, n, nl, vertex, t=0.0):
    w = jnc.NCWriter(path, names, n, nl=nl if nl > 1 else None, L0=1.0,
                     vertex=vertex, surface_vars=("bs",))
    w.append(t, **fields)
    w.close()


def _bs0(M, seed=4):
    bs = 1e-2 * np.random.default_rng(seed).uniform(-1, 1, (M, M))
    bs[0] = bs[-1] = bs[:, 0] = bs[:, -1] = 0.0
    return bs


def test_run_newqg_matches_jax_from_a_restart(tmp_path):
    """Both runs pick up one restart.nc (its last record at t = 0.05) and
    run to tend = 0.15 with dtout = 0.05: three records, the restart
    backed up."""
    rp = str(tmp_path / "restart.nc")
    _restart_file(rp, ["psi"], dict(psi=_psi0(1, 32)), 32, 1, False,
                  t=0.05)
    kw = dict(NEWQG, tend=0.15)
    outs = []
    ts, tout = tdn.run_newqg(tnq.NewQGConfig(**kw),
                             outdir=str(tmp_path / "port"), restart=rp,
                             device="cpu", hooks=tdn.RunHooks(
                                 on_output=lambda s, t: outs.append(t)))
    js, _ = jdn.run_newqg(jnq.NewQGConfig(**kw),
                          outdir=str(tmp_path / "jax"), restart=rp)
    assert np.allclose(outs, [0.05, 0.1, 0.15])
    for name in ("q", "psi"):
        assert _rel(getattr(ts, name), getattr(js, name)) < LIMIT, name
    assert float(ts.t) == pytest.approx(0.15, abs=1e-12)
    assert int(ts.i) == int(js.i)
    assert os.path.exists(os.path.join(tout.dir, "restart.nc.bak"))
    times = _files_agree(tout.dir, str(tmp_path / "jax"), ["psi", "q"])
    assert np.allclose(times, [0.05, 0.1, 0.15])


def test_run_sqg_matches_jax_from_a_restart(tmp_path):
    """psi and bs from one restart.nc (t = 0.025), to tend = 0.075 with
    dtout = 0.025."""
    rp = str(tmp_path / "restart.nc")
    _restart_file(rp, ["psi", "bs"], dict(psi=_psi0(2, 17), bs=_bs0(17)),
                  16, 2, True, t=0.025)
    kw = dict(SQG, tend=0.075)
    jcfg, tcfg = jnode.NodeQGConfig(**kw), tnode.NodeQGConfig(**kw)
    ts, tout = tdn.run_sqg(tcfg, outdir=str(tmp_path / "port"), restart=rp,
                           device="cpu")
    js, _ = jdn.run_sqg(jcfg, outdir=str(tmp_path / "jax"), restart=rp)
    for name in ("q", "bs", "psi"):
        assert _rel(getattr(ts, name), getattr(js, name)) < LIMIT, name
    assert float(ts.t) == pytest.approx(0.075, abs=1e-12)
    assert os.path.exists(os.path.join(tout.dir, "restart.nc.bak"))
    times = _files_agree(tout.dir, str(tmp_path / "jax"), ["psi", "q", "bs"])
    assert np.allclose(times, [0.025, 0.05, 0.075])
    f, _ = tnc.read_nc(os.path.join(tout.dir, "vars.nc"), ["psi", "bs"])
    assert f["psi"].shape == (2, 17, 17) and f["bs"].shape == (17, 17)


@pytest.mark.parametrize("model", ["newqg", "sqg"])
def test_cli_matches_jax(tmp_path, model):
    """`--model newqg|sqg --cpu` against the JAX package's main on one
    params.in, both from one restart.nc."""
    deck = NEWQG_DECK if model == "newqg" else SQG_DECK
    (tmp_path / "params.in").write_text(deck)
    rp = str(tmp_path / "restart.nc")
    if model == "newqg":
        _restart_file(rp, ["psi"], dict(psi=_psi0(1, 32)), 32, 1, False)
    else:
        _restart_file(rp, ["psi", "bs"], dict(psi=_psi0(2, 17), bs=_bs0(17)),
                      16, 2, True)
    args = ["--model", model, "--config", str(tmp_path / "params.in"),
            "--restart", rp, "--steps", "6"]
    state, out = tdn.main(args + ["--outdir", str(tmp_path / "port"),
                                  "--cpu"])
    jdn.main(args + ["--outdir", str(tmp_path / "jax"), "--cpu"])
    names = ["psi", "q"] + (["bs"] if model == "sqg" else [])
    _files_agree(out.dir, str(tmp_path / "jax"), names)
    assert int(state.i) == 6 and state.q.device.type == "cpu"
    with open(tmp_path / "port" / "params.in") as f:
        assert f.read() == deck


def test_float32_model_time_reaches_events_it_cannot_represent(tmp_path):
    """In float32 the model time lands on f32(0.45) < 0.45 - 1e-10, so with
    the JAX drivers' fixed 1e-10 (msom_tpu/driver_node.py:359, :364 in
    run_newqg; run_sqg compares the same way) the output event never fires
    and every later step has dt = 0 until max_steps (shown on the JAX
    run_newqg below). The port fires each event once, within 16 units in
    the last place of t, and never takes a step of dt = 0."""
    kw = dict(NEWQG, N=16, dtype="float32", dtout=0.45, tend=0.9, DT=0.1,
              beta=0.0, tau0=0.0)
    tcfg, jcfg = tnq.NewQGConfig(**kw), jnq.NewQGConfig(**kw)
    psi0 = 1e-4 * _psi0(1, 16)
    logs, outs = [], []
    _, tlam = tnq.build_levels(tcfg, device="cpu")
    ts, _ = tdn.run_newqg(
        tcfg, lam=tlam, state=tnq.init_state(tcfg, tlam, psi0=psi0),
        outdir=str(tmp_path / "t"), restart=None, max_steps=200,
        hooks=tdn.RunHooks(on_log=lambda *a: logs.append(a),
                           on_output=lambda st, t: outs.append(t)))
    assert int(ts.i) < 60 and min(dt for _, dt, _, _ in logs) > 0
    assert np.allclose(outs, [0.0, 0.45, 0.9])
    assert float(ts.t) == np.float32(0.9)
    _, jlam = jnq.build_levels(jcfg)
    jlogs = []
    js, _ = jdn.run_newqg(jcfg, lam=jlam, state=jnq.init_state(
        jcfg, jlam, psi0=psi0), outdir=str(tmp_path / "j"), restart=None,
        max_steps=60, hooks=jdn.RunHooks(on_log=lambda *a: jlogs.append(a)))
    assert int(js.i) == 60 and jlogs[-1][1] == 0.0
    assert sum(dt == 0.0 for _, dt, _, _ in jlogs) > 30
