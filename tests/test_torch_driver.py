"""The port's msqg driver (driver.py: run_qg, OutputWriter, stdout_hooks,
main) and its I/O (io/bas.py, io/deck.py, io/checkpoint.py, convert.py's
filter leaves) against the JAX package, on the Verron double gyre of
msom_tpu/configs/double_gyre_small.in (128^2 x 3) in float64 on the CPU.

run_qg is run from one numpy psi0 with the wavelet filter (dtflt = 0.25)
and the energy budget (ediag = 0) on, to tend = 0.75 with dtout = 0.5:
about 30 steps, the output event at t = 0 and 0.5 and the filter event at
0.25 and 0.5. Tolerances: the final q, psi, qof and the six energy fields
to 1e-11 of their maxima, the KE log to 1e-11 (tests/test_lockstep.py's);
each .bas file within float32 rounding, 2^-23 of the file's max|value|
(the two runs round values that differ by 1e-11 to float32, and a value
at a rounding boundary may fall either way); .bas bytes and deck arrays
exactly."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msom_tpu import driver as jdriver
from msom_tpu.io import bas as jbas
from msom_tpu.io import checkpoint as jckpt
from msom_tpu.io import deck as jdeck
from msom_tpu.models import qg as jqg
from msom_tpu.ops import wavelet as jwv
from msom_tpu.params import load_qg_config as jload
from msom_tpu_torch import convert
from msom_tpu_torch import driver as tdriver
from msom_tpu_torch.io import bas as tbas
from msom_tpu_torch.io import checkpoint as tckpt
from msom_tpu_torch.io import deck as tdeck
from msom_tpu_torch.models import qg as tqg
from msom_tpu_torch.models import qg_energy as ten
from msom_tpu_torch.ops import wavelet as twv
from msom_tpu_torch.params import load_qg_config as tload

from test_torch_wavelet import rdpg_field, rel, rough

torch.set_num_threads(1)

DECK = os.path.join(os.path.dirname(__file__), "..", "msom_tpu", "configs",
                    "double_gyre_small.in")
# two output and two filter events in about 30 steps, energy budget on
EVENTS = dict(dtype="float64", solver="spectral", dtflt=0.25, dtout=0.5,
              tend=0.75, ediag=0, afilt=7.0)
TRACERS = dict(nptr=2, Pe=(1e3, 2e3), ptr_r=(100.0, 0.0))
RUNS = {
    "walled": dict(),
    "coupled": dict(**TRACERS),
    "periodic": dict(sbc=-1.0),
}


def configs(**kw):
    over = dict(EVENTS, **kw)
    return jload(DECK, **over), tload(DECK, **over)


def coupling(cfg, seed=0):
    """bench.py's coupling inputs (bench.py:69-74) at the deck's size: a
    gyre-shaped large-scale streamfunction and a sine topography, with a
    numpy tracer IC."""
    N, nl = cfg.N, cfg.nl
    y = (np.arange(N) + 0.5) * cfg.delta
    gyre = np.sin(np.pi * y / cfg.L0)
    rng = np.random.default_rng(seed)
    return (dict(psipg=0.01 * gyre[None, :, None] * np.ones((nl, N, N)),
                 topo=0.05 * np.outer(gyre, np.sin(2 * np.pi * y / cfg.L0))),
            dict(tracers0=1e-3 * rng.uniform(-1, 1, (nl, cfg.nptr, N, N))))


def f32_close(got, want):
    """Equal within float32 rounding of the larger field."""
    scale = np.abs(want).max()
    return np.abs(got - want).max() <= 2.0 ** -23 * scale


def same_files(dir_t, dir_j):
    """The same file names, each .bas within float32 rounding and each
    other file byte for byte; returns the names."""
    names = sorted(os.listdir(dir_t))
    assert names == sorted(os.listdir(dir_j))
    for name in names:
        pt, pj = os.path.join(dir_t, name), os.path.join(dir_j, name)
        if name.endswith(".bas"):
            ft, xt, yt = tbas.read_bas(pt)
            fj, xj, yj = jbas.read_bas(pj)
            assert ft.shape == fj.shape, name
            assert f32_close(ft, fj), name
            np.testing.assert_array_equal(xt, xj)
            np.testing.assert_array_equal(yt, yj)
        else:
            with open(pt, "rb") as a, open(pj, "rb") as b:
                assert a.read() == b.read(), name
    return names


def run_both(tmp_path, run, **over):
    jcfg, tcfg = configs(**RUNS[run], **over)
    rng = np.random.default_rng(42)
    psi0 = 1e-3 * rng.uniform(-1, 1, (3, 128, 128))
    inputs, init = coupling(tcfg) if run == "coupled" else ({}, {})
    inputs["rdpg"] = rdpg_field(128)
    out = {}
    for name, dr, qg, cfg in (("jax", jdriver, jqg, jcfg),
                              ("port", tdriver, tqg, tcfg)):
        kw = {} if name == "jax" else {"device": "cpu"}
        const = qg.build_constants(cfg, **inputs, **kw)
        state = qg.init_state(cfg, const, psi0=psi0, **init)
        logs = []
        hooks = dr.RunHooks(on_log=lambda *a: logs.append(a))
        hooks.on_output = dr.OutputWriter(cfg, const,
                                          outdir=str(tmp_path / name),
                                          params_text="N = 128\n")
        if name == "jax":
            state = dr.run_qg(cfg, const=const, state=state, hooks=hooks)
            energy = dr.run_qg.energy
        else:
            state, energy = dr.run_qg(cfg, const=const, state=state,
                                      hooks=hooks)
        out[name] = state, energy, logs
    return out


@pytest.mark.parametrize("run", list(RUNS))
def test_run_qg_matches_jax(tmp_path, run):
    out = run_both(tmp_path, run)
    (js, jenergy, jlog), (ts, tenergy, tlog) = out["jax"], out["port"]
    for name in ("q", "psi", "qof") + (("tracers",) if run == "coupled"
                                       else ()):
        r = rel(getattr(ts, name), getattr(js, name))
        assert r < 1e-11, f"{name}: {r:.3e}"
    assert int(ts.nbar) == int(js.nbar) == 2
    assert int(ts.i) == int(js.i) and 25 <= int(ts.i) <= 40
    assert float(ts.t) == pytest.approx(0.75, abs=1e-12)
    for name in ten.FIELDS + ("po_mft",):
        got = getattr(tenergy, name).numpy()
        want = np.asarray(getattr(jenergy, name))
        if name == "de_j2" and run != "coupled":    # no pp: exactly 0
            assert not got.any() and not want.any()
        else:
            r = rel(got, want)
            assert r < 1e-11, f"energy {name}: {r:.3e}"
    assert float(tenergy.de_ft.abs().max()) > 0
    assert len(tlog) == len(jlog) == int(ts.i)
    for (ti, tdt, tt, tke), (ji, jdt, jt, jke) in zip(tlog, jlog):
        assert ti == ji
        assert abs(tdt - jdt) <= 1e-11 * jdt and abs(tt - jt) <= 1e-11
        assert abs(tke - jke) <= 1e-11 * abs(jke), f"KE at step {ti}"
    names = same_files(tmp_path / "port", tmp_path / "jax")
    i_mid = [n for n in names if n.startswith("po")]
    assert len(i_mid) == 2                      # the events at t = 0, 0.5
    for kind in ("qo", "pf", "de_ft", "de_j1") + (
            ("ptr", "topo_N128.bas") if run == "coupled" else ()):
        assert any(n.startswith(kind) for n in names), kind


def test_step_carries_the_filter_mean_through():
    """The step does not touch qof and nbar (only the filter event does),
    so the mean survives the steps between events."""
    _, tcfg = configs()
    const = tqg.build_constants(tcfg, device="cpu")
    state = tqg.init_state(tcfg, const, psi0=1e-3 * rough((3, 128, 128), 3))
    state = twv.wavelet_filter_step(tcfg, const, state)
    qof, nbar = state.qof.clone(), int(state.nbar)
    step = tqg.make_step(tcfg)
    for _ in range(3):
        state, _ = step(state, const, 1e9)
        assert state.qof is not None and state.nbar is not None
        assert torch.equal(state.qof, qof) and int(state.nbar) == nbar


def test_float32_model_time_reaches_events_it_cannot_represent():
    """In float32 the model time lands on f32(0.45) < 0.45 - 1e-10, so
    with the JAX driver's fixed 1e-10 the output event never fires and
    every later step has dt = 0 until max_steps (shown on the JAX driver
    below). The port fires each event once, within 16 units in the last
    place of t, and never takes a step of dt = 0."""
    kw = dict(N=32, dtype="float32", dtout=0.45, dtflt=0.3, tend=0.9,
              ediag=-1)
    jcfg, tcfg = configs(**kw)
    psi0 = 1e-3 * rough((3, 32, 32), 11)
    outs, flts, logs = [], [], []
    hooks = tdriver.RunHooks(on_log=lambda *a: logs.append(a),
                             on_output=lambda st, t: outs.append(t),
                             on_filter=lambda st, t: flts.append(t))
    const = tqg.build_constants(tcfg, device="cpu")
    state, energy = tdriver.run_qg(
        tcfg, const=const, state=tqg.init_state(tcfg, const, psi0=psi0),
        hooks=hooks, max_steps=200)
    assert energy is None and int(state.i) < 60
    assert min(dt for _, dt, _, _ in logs) > 0
    assert np.allclose(outs, [0.0, 0.45, 0.9]) and np.allclose(flts,
                                                              [0.3, 0.6])
    assert float(state.t) == np.float32(0.9)
    jc = jqg.build_constants(jcfg)
    jlogs = []
    js = jdriver.run_qg(jcfg, const=jc,
                        state=jqg.init_state(jcfg, jc, psi0=psi0),
                        hooks=jdriver.RunHooks(
                            on_log=lambda *a: jlogs.append(a)),
                        max_steps=60)
    assert int(js.i) == 60 and jlogs[-1][1] == 0.0


def test_time_filter_matches_jax():
    q, q_mean = rough((3, 32, 32), 13), rough((3, 32, 32), 14)
    got = tqg.time_filter(torch.as_tensor(q), torch.as_tensor(q_mean),
                          torch.tensor(0.05, dtype=torch.float64))
    want = jqg.time_filter(jnp.asarray(q), jnp.asarray(q_mean), 0.05)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rel(tqg.time_filter(torch.as_tensor(q), torch.as_tensor(q_mean),
                               0.05, tau_f=5.0),
               np.asarray(jqg.time_filter(jnp.asarray(q),
                                          jnp.asarray(q_mean), 0.05,
                                          tau_f=5.0))) < 1e-15


def test_stdout_heartbeat_format(capsys):
    tdriver.stdout_hooks().on_log(7, 0.05, 1.25, 3.5e-6)
    jdriver.stdout_hooks().on_log(7, 0.05, 1.25, 3.5e-6)
    t_line, j_line = capsys.readouterr().out.splitlines()
    assert t_line == j_line == "i = 7, dt = 0.05, t = 1.25, ke_1 = 3.5e-06"


def test_next_event_matches_jax():
    for t, cadence in ((0.0, 0.25), (0.25, 0.25), (0.2499999999999, 0.25),
                       (0.3, 0.5), (1.0, -1.0)):
        assert tdriver._next_event(t, cadence) == \
            jdriver._next_event(t, cadence)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

PARAMS = """\
N = 128
nl = 3
L0 = 80.
Rom = 0.025
Ekb = 0.002
tau0 = 1e-4
Re4 = 391
beta = 0.5
Fr = [0.0023669,0.0076173]
dh = [0.06,0.14,0.8]
DT = 5e-2
tend = 500.
dtout = 0.25
dtflt = 0.2
ediag = 0
afilt = 7
CFL = 0.6
dtype = float64
solver = spectral
"""


def write_deck(d):
    os.makedirs(d)
    with open(os.path.join(d, "params.in"), "w") as f:
        f.write(PARAMS)
    rng = np.random.default_rng(1)
    jbas.write_bas(os.path.join(d, "p0.bas"),
                   1e-3 * rng.uniform(-1, 1, (3, 128, 128)), 80.0)
    jbas.write_bas(os.path.join(d, "rdpg_3l_N128.bas"), rdpg_field(128),
                   80.0)
    return os.path.join(d, "params.in")


def test_cli_matches_jax_main(tmp_path, capsys):
    cfgpath = write_deck(str(tmp_path / "deck"))
    common = ["--config", cfgpath, "--cpu", "--steps", "20"]
    jdriver.main(common + ["--outdir", str(tmp_path / "jax")])
    j_out = capsys.readouterr().out.splitlines()
    result = tdriver.main(common + ["--outdir", str(tmp_path / "port")])
    t_out = capsys.readouterr().out.splitlines()
    j_result = json.loads(j_out[-1])
    assert json.loads(t_out[-1]) == result
    assert result["steps"] == j_result["steps"] == 20
    assert abs(result["t"] - j_result["t"]) <= 1e-12
    assert result["points_per_s"] > 0 and result["wall_s"] > 0
    # the deck report and the KE heartbeat, line for line but the digits
    assert [l for l in t_out if l.endswith(".. ok")] == \
        ["rdpg_3l_N128.bas .. ok", "p0.bas .. ok"]
    t_ke = [l for l in t_out if l.startswith("i = ")]
    j_ke = [l for l in j_out if l.startswith("i = ")]
    assert len(t_ke) == len(j_ke) == 20
    assert [l.split(",")[0] for l in t_ke] == [l.split(",")[0] for l in j_ke]
    names = same_files(tmp_path / "port", tmp_path / "jax")
    assert "params.in" in names and "rdpg_3l_N128.bas" in names
    assert sum(n.startswith("pf") for n in names) >= 2
    with open(tmp_path / "port" / "params.in") as f:
        assert f.read() == PARAMS


# an mspg deck (tests/test_torch_driver_pg.py's physics)
PG_PARAMS = """N = 16
nl = 4
ys = 0.3
r = 0.02
tau_s = 3e-2
tau0 = 0.12
kv = 1e-4
kh = 1e-4
omega = 0.2
DT = 1e-2
CFL = 0.4
tend = 10
dtout = 0.05
dtype = float64
"""


@pytest.mark.parametrize("args,match", [
    pytest.param(["--model", "pg", "--sharded"], "item 15",
                 id="args0-item 15"),
    pytest.param(["--sharded", "--sharded-mode", "gspmd"], None,
                 id="args1-item 15"),
])
def test_cli_refuses_what_is_not_ported(tmp_path, args, match):
    """Both, once refused, run at world size 1: `--model pg --sharded` the
    rows-sharded mspg step on an mspg deck, `--sharded-mode gspmd` the
    general-mesh step: the same steps and model time as the unsharded
    CLI. The case ids "item 15", from when these were refused, are kept
    only to keep the test ids."""
    if args[:2] == ["--model", "pg"]:
        os.makedirs(tmp_path / "deck")
        cfgpath = str(tmp_path / "deck" / "params.in")
        with open(cfgpath, "w") as f:
            f.write(PG_PARAMS)
    else:
        cfgpath = write_deck(str(tmp_path / "deck"))
    common = ["--config", cfgpath, "--cpu", "--no-output"]
    one = tdriver.main(common + ["--steps", "2"]
                       + [a for a in args if a != "--sharded"])
    got = tdriver.main(common + ["--steps", "2"] + args)
    assert got["ranks"] == 1 and got["steps"] == one["steps"] == 2
    assert abs(got["t"] - one["t"]) <= 1e-12 * one["t"]


def test_run_qg_sharded_raises():
    """The GSPMD mode, once refused, runs: run_qg(sharded="gspmd") returns
    the mode the JAX package's run_qg records and the unsharded run's
    state (the general-mesh step at world size 1). The name, from when
    the mode was refused, is kept only to keep the test id: it checks
    that the mode runs."""
    jcfg, tcfg = configs()
    jdriver.run_qg(dataclasses.replace(jcfg, tend=0.0), sharded="gspmd")
    out = [tdriver.run_qg(tcfg, sharded=sharded, max_steps=3, device="cpu")
           for sharded in ("gspmd", False)]
    assert out[0][2] == jdriver.run_qg.sharded_mode == "gspmd"
    assert rel(out[0][0].q, out[1][0].q) < 1e-12


def test_output_writer_picks_the_next_free_outdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    os.makedirs("outdir_0001")
    _, tcfg = configs(N=16)
    const = tqg.build_constants(tcfg, device="cpu")
    w = tdriver.OutputWriter(tcfg, const)
    assert w.dir == "outdir_0002"
    assert sorted(os.listdir(w.dir)) == sorted(
        ["sig_filt.bas", "rdpg_3l_N16.bas", "psipg_3l_N16.bas",
         "frpg_3l_N16.bas", "dh_3l.bin"])


# ---------------------------------------------------------------------------
# .bas, the deck, the checkpoint and convert's filter leaves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 16), (3, 32, 32)])
def test_write_bas_writes_jax_bytes(tmp_path, shape):
    f = np.random.default_rng(4).standard_normal(shape)
    tbas.write_bas(str(tmp_path / "t.bas"), f, 80.0, x0=1.5, y0=-2.0)
    jbas.write_bas(str(tmp_path / "j.bas"), f, 80.0, x0=1.5, y0=-2.0)
    with open(tmp_path / "f.bas", "wb") as fp:    # a file object too
        tbas.write_bas(fp, f, 80.0, x0=1.5, y0=-2.0)
    data = [(tmp_path / n).read_bytes() for n in ("t.bas", "j.bas", "f.bas")]
    assert data[0] == data[1] == data[2]
    got, want = tbas.read_bas(str(tmp_path / "t.bas")), \
        jbas.read_bas(str(tmp_path / "j.bas"))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="square"):
        tbas.write_bas(str(tmp_path / "x.bas"), np.zeros((4, 5)), 1.0)


def test_load_qg_deck_matches_jax(tmp_path):
    """Every input file of an msqg deck, read by both; the constants built
    from it, frpg included, are the JAX package's."""
    d = str(tmp_path)
    nl, N, nptr = 2, 16, 2
    with open(os.path.join(d, "params.in"), "w") as f:
        f.write(f"N = {N}\nnl = {nl}\nL0 = 1\nRom = 0.1\nFr = [0.003]\n"
                f"dh = [0.5,0.5]\nnptr = {nptr}\nPe = [1e3,1e3]\n"
                "ptr_r = [10,10]\n")
    rng = np.random.default_rng(5)
    for name, shape in (("p0.bas", (nl, N, N)),
                        (f"psipg_{nl}l_N{N}.bas", (nl, N, N)),
                        (f"frpg_{nl}l_N{N}.bas", (nl - 1, N, N)),
                        (f"rdpg_{nl}l_N{N}.bas", (N, N)),
                        ("topo.bas", (N, N)),
                        (f"qforc_{nl}l_N{N}.bas", (nl, N, N)),
                        (f"s_stoch_{nl}l_N{N}.bas", (nl, N, N)),
                        ("ptr0.bas", (nl * nptr, N, N)),
                        ("ptr_relax.bas", (nl * nptr, N, N))):
        jbas.write_bas(os.path.join(d, name), rng.standard_normal(shape), 1.0)
    np.asarray([0.4, 0.6], np.float32).tofile(os.path.join(d, "dh_2l.bin"))
    cfgpath = os.path.join(d, "params.in")
    logged = []
    got = tdeck.load_qg_deck(tload(cfgpath), d, log=logged.append)
    want = jdeck.load_qg_deck(jload(cfgpath), d)
    assert got["found"] == want["found"] and len(got["found"]) == 10
    assert logged == [f"{n} .. ok" for n in got["found"]]
    for part in ("const", "init"):
        assert sorted(got[part]) == sorted(want[part])
        for key in got[part]:
            np.testing.assert_array_equal(got[part][key], want[part][key])
            assert got[part][key].dtype == want[part][key].dtype, key
    tc = tqg.build_constants(tload(cfgpath), device="cpu", **got["const"])
    jc = jqg.build_constants(jload(cfgpath), **want["const"])
    assert not tc.rhs_kernel
    for name in ("strl", "Rd", "qforc", "s_stoch"):
        np.testing.assert_array_equal(
            getattr(tc, name).expand(np.shape(getattr(jc, name))).numpy(),
            np.asarray(getattr(jc, name)))


def test_checkpoint_round_trips_the_filter_mean(tmp_path):
    _, tcfg = configs(N=32, solver="mg")
    const = tqg.build_constants(tcfg, device="cpu")
    state = tqg.init_state(tcfg, const, psi0=1e-3 * rough((3, 32, 32), 8))
    state, _ = tqg.make_step(tcfg)(state, const, 1e9)
    state = twv.wavelet_filter_step(tcfg, const, state)
    path = str(tmp_path / "s.npz")
    tckpt.save_state(path, state)
    fresh = tqg.init_state(tcfg, const, seed=1)
    back = tckpt.load_state(path, fresh)
    for name in ("q", "psi", "t", "dt_prev", "i", "qof", "nbar", "psi_old"):
        a, b = getattr(back, name), getattr(state, name)
        assert torch.equal(a, b) and a.dtype == b.dtype, name
    assert back.tracers is None and int(back.nbar) == 1
    with pytest.raises(ValueError, match="generator"):
        tckpt.load_state(path, fresh, torch.Generator())


def test_restarted_stochastic_run_continues_the_stream(tmp_path):
    """Five steps, a checkpoint with the generator's state, five more,
    against ten steps without a break, bit for bit: the restart goes
    through run_qg with a fresh generator seeded otherwise, which
    load_state sets to the saved stream."""
    _, tcfg = configs(N=32, stochastic=True, tr_stoch=50.0, amp_stoch=1e-5,
                      dtflt=-1.0, ediag=-1, tend=1e9)
    const = tqg.build_constants(tcfg, device="cpu")
    psi0 = 1e-3 * rough((3, 32, 32), 9)
    whole, _ = tdriver.run_qg(tcfg, const=const,
                              state=tqg.init_state(tcfg, const, psi0=psi0),
                              max_steps=10, seed=3)
    gen = torch.Generator().manual_seed(3)
    half, _ = tdriver.run_qg(tcfg, const=const,
                             state=tqg.init_state(tcfg, const, psi0=psi0),
                             max_steps=5, generator=gen)
    path = str(tmp_path / "half.npz")
    tckpt.save_state(path, half, generator=gen)
    gen2 = torch.Generator().manual_seed(99)
    resumed = tckpt.load_state(path, tqg.init_state(tcfg, const, seed=0),
                               generator=gen2)
    again, _ = tdriver.run_qg(tcfg, const=const, state=resumed,
                              max_steps=10, generator=gen2)
    assert int(again.i) == int(whole.i) == 10
    for name in ("q", "psi", "t", "dt_prev"):
        assert torch.equal(getattr(again, name), getattr(whole, name)), name
    # the kick is there: the same run without noise differs
    quiet, _ = tdriver.run_qg(dataclasses.replace(tcfg, amp_stoch=0.0),
                              const=const,
                              state=tqg.init_state(tcfg, const, psi0=psi0),
                              max_steps=10, seed=3)
    assert not torch.equal(quiet.q, whole.q)


def test_jax_state_after_a_filter_event_resumes_in_the_port(tmp_path):
    """A JAX run with two filter events, saved by msom_tpu's save_state,
    continues in the port: the filter mean carries over exactly, and two
    steps and the next event agree with JAX's."""
    jcfg, tcfg = configs(N=64)
    psi0 = 1e-3 * rough((3, 64, 64), 10)
    rd = rdpg_field(64)
    jc = jqg.build_constants(jcfg, rdpg=rd)
    js = jqg.init_state(jcfg, jc, psi0=psi0)
    jstep = jax.jit(jqg.make_step(jcfg))
    tnext = jnp.asarray(1e9, js.t.dtype)
    for _ in range(2):
        for _ in range(3):
            js, _ = jstep(js, jc, tnext)
        js = jwv.wavelet_filter_step(jcfg, jc, js)
    path = str(tmp_path / "state.npz")
    jckpt.save_state(path, js)
    leaves = dict(np.load(path))
    ts = convert.state_from_numpy(tcfg, leaves, device="cpu")
    assert int(ts.nbar) == 2 and ts.nbar.dtype == torch.int32
    np.testing.assert_array_equal(ts.qof.numpy(), leaves["qof"])
    back = convert.state_to_numpy(ts)
    for name in ("qof", "nbar"):
        np.testing.assert_array_equal(back[name], leaves[name])
        assert back[name].dtype == leaves[name].dtype
    tc = tqg.build_constants(tcfg, device="cpu", rdpg=rd)
    tstep = tqg.make_step(tcfg)
    for _ in range(2):
        js, _ = jstep(js, jc, tnext)
        ts, _ = tstep(ts, tc, 1e9)
    js = jwv.wavelet_filter_step(jcfg, jc, js)
    ts = twv.wavelet_filter_step(tcfg, tc, ts)
    assert int(ts.nbar) == int(js.nbar) == 3
    for name in ("q", "psi", "qof"):
        assert rel(getattr(ts, name), getattr(js, name)) < 1e-12, name
    # a config without the filter refuses the leaves, one with it needs them
    with pytest.raises(ValueError, match="filter"):
        convert.state_from_numpy(configs(N=64, dtflt=-1.0)[1], leaves,
                                 device="cpu")
    del leaves["nbar"]
    with pytest.raises(ValueError, match="filter"):
        convert.state_from_numpy(tcfg, leaves, device="cpu")
