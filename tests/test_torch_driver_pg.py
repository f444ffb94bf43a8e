"""The port's mspg driver (driver.run_pg, PGOutputWriter, main --model pg),
its deck reader (io/deck.load_pg_deck) and convert's PG state against the
JAX package, f64 on the CPU at 16^2 x 4 (the lockstep test's physics).

run_pg runs to tend = 0.3 with dtout = 0.1 from one numpy stratified IC:
97 steps (the CFL limit), the running means every 10 steps and the output
event at t = 0, 0.1, 0.2, 0.3. Tolerances: the state and the means at each output
event to 1e-11 of their maxima; each .bas file within float32 rounding
(2^-23 of the file's max|value|); the deck's arrays exactly."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msom_tpu import driver as jdriver
from msom_tpu.io import deck as jdeck
from msom_tpu.models import mspg as jm
from msom_tpu.params import PGConfig as JPG
from msom_tpu_torch import convert
from msom_tpu_torch import driver as tdriver
from msom_tpu_torch.io import deck as tdeck
from msom_tpu_torch.models import mspg as tm
from msom_tpu_torch.params import PGConfig as TPG

from test_torch_driver import same_files

torch.set_num_threads(1)

BASE = dict(N=16, nl=4, ys=0.3, r=0.02, tau_s=3e-2, tau0=0.12, kv=1e-4,
            kh=1e-4, omega=0.2, DT=1e-2, CFL=0.4, tend=0.3, dtout=0.1,
            dtype="float64")
FIELDS = ("b", "ux", "uy", "b_me", "ux_me", "uy_me")


def configs(**kw):
    return JPG(**{**BASE, **kw}), TPG(**{**BASE, **kw})


def rel(got, want):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    want = np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def b_ic(cfg, seed=9):
    rng = np.random.default_rng(seed)
    return (np.linspace(1.0, 0.0, cfg.nl)[:, None, None]
            + 0.2 * rng.standard_normal((cfg.nl, cfg.N, cfg.N)))


@pytest.fixture(scope="module")
def built():
    jcfg, tcfg = configs()
    return jcfg, tcfg, jm.build_constants(jcfg), tm.build_constants(
        tcfg, device="cpu")


def snapshot(state):
    return {name: np.array(getattr(state, name)) for name in FIELDS} | {
        "t": float(state.t), "i": int(state.i), "nme": int(state.nme)}


def test_run_pg_matches_jax(built, tmp_path):
    """The state, the means and nme at every output event and at the end;
    the .bas files of both writers."""
    jcfg, tcfg, jc, tc = built
    b0 = b_ic(tcfg)
    events, finals = {}, {}
    for name, dr, m, cfg, const in (("jax", jdriver, jm, jcfg, jc),
                                    ("port", tdriver, tm, tcfg, tc)):
        writer = dr.PGOutputWriter(cfg, const, outdir=str(tmp_path / name),
                                   params_text="N = 16\n")
        seen, logs = [], []

        def on_output(state, t, writer=writer, seen=seen):
            writer(state, t)
            seen.append(snapshot(state))

        hooks = dr.RunHooks(on_log=lambda *a, logs=logs: logs.append(a),
                            on_output=on_output)
        state = dr.run_pg(cfg, const=const,
                          state=m.init_state(cfg, const, b0=b0), hooks=hooks)
        events[name], finals[name] = (seen, logs), snapshot(state)
    (t_seen, t_logs), (j_seen, j_logs) = events["port"], events["jax"]
    assert [s["t"] for s in t_seen] == pytest.approx(
        [0.0, 0.1, 0.2, 0.3], abs=1e-12)
    assert len(t_seen) == len(j_seen) and len(t_logs) == len(j_logs) > 20
    for got, want in zip(t_seen + [finals["port"]], j_seen + [finals["jax"]]):
        assert got["i"] == want["i"] and got["nme"] == want["nme"]
        assert got["t"] == pytest.approx(want["t"], abs=1e-13)
        for name in FIELDS:
            assert rel(got[name], want[name]) < 1e-11, name
    # nme counts the 10-step samples since the last output, then resets
    assert [s["nme"] for s in t_seen][1:] == [s["i"] // 10 - p["i"] // 10
                                              for p, s in zip(t_seen,
                                                              t_seen[1:])]
    assert finals["port"]["nme"] == 0
    for (i, dt, t, ke), (ji, jdt, jt, jke) in zip(t_logs, j_logs):
        assert i == ji and ke == jke == 0.0
        assert dt == pytest.approx(jdt, rel=1e-12)
    names = same_files(tmp_path / "port", tmp_path / "jax")
    assert "psibt.bas" in names and "params.in" in names
    assert sum(n.startswith("b0") for n in names) == 4


def test_pg_deck_round_trips_the_writers_files(built, tmp_path):
    """A state dump read back as a deck (b0, u0 with the ghost layers, and
    the bf_pg forcing at nl blocks), by both readers."""
    jcfg, tcfg, jc, tc = built
    state = tm.init_state(tcfg, tc, b0=b_ic(tcfg))
    step = tm.make_step(tcfg)
    for _ in range(3):
        state, _ = step(state, tc, 1e18)
    state = tm.accumulate_means(state)
    tdriver.PGOutputWriter(tcfg, tc, outdir=str(tmp_path))(state, 0.0)
    i = int(state.i)
    shutil.copy(tmp_path / f"b{i:09d}.bas", tmp_path / "b0.bas")
    shutil.copy(tmp_path / f"u{i:09d}.bas", tmp_path / "u0.bas")
    from msom_tpu_torch.io.bas import write_bas
    bf = np.random.default_rng(1).standard_normal((4, 16, 16))
    write_bas(str(tmp_path / "bf_pg.bas"), bf, 1.0)
    logged = []
    got = tdeck.load_pg_deck(tcfg, str(tmp_path), log=logged.append)
    want = jdeck.load_pg_deck(jcfg, str(tmp_path))
    assert got["found"] == want["found"] == ["b0.bas", "u0.bas",
                                            "bf_pg.bas"]
    assert logged == [f"{n} .. ok" for n in got["found"]]
    np.testing.assert_array_equal(got["init"]["b0"], want["init"]["b0"])
    for g, w in zip(got["init"]["u0"], want["init"]["u0"]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got["const"]["b_forc"],
                                  want["const"]["b_forc"])
    # float32 files: the means come back within float32 rounding, the
    # trailing wall faces as zeros
    assert np.abs(got["init"]["b0"] - state.b_me.numpy()).max() \
        <= 2.0 ** -23 * np.abs(state.b_me.numpy()).max()
    ux0, uy0 = got["init"]["u0"]
    assert np.abs(ux0[..., :-1] - state.ux_me.numpy()[..., :-1]).max() \
        <= 2.0 ** -23 * np.abs(state.ux_me.numpy()).max()
    assert not ux0[..., -1].any() and not uy0[:, -1].any()
    s0 = tm.init_state(tcfg, tm.build_constants(
        tcfg, device="cpu", **got["const"]), **got["init"])
    assert s0.ux.shape == (4, 16, 17) and s0.uy.shape == (4, 17, 16)
    with pytest.raises(ValueError, match="layer blocks"):
        tdeck._strip_ghost_layers(np.zeros((5, 16, 16)), 4)


PARAMS = """# mspg deck (pg.c:60-76 keys; kd, a and nu are not read)
N = 16
nl = 4
ys = 0.3
r = 0.02
tau_s = 3e-2
tau0 = 0.12
kv = 1e-4
kh = 1e-4
kd = 1e-3
omega = 0.2
DT = 1e-2
CFL = 0.4
tend = 10
dtout = 0.05
dtype = float64
"""


def test_cli_model_pg_matches_jax_main(tmp_path, capsys):
    d = tmp_path / "deck"
    os.makedirs(d)
    with open(d / "params.in", "w") as f:
        f.write(PARAMS)
    from msom_tpu_torch.io.bas import write_bas
    write_bas(str(d / "b0.bas"), b_ic(TPG(N=16, nl=4)), 1.0)
    common = ["--config", str(d / "params.in"), "--model", "pg", "--cpu",
              "--steps", "20"]
    jdriver.main(common + ["--outdir", str(tmp_path / "jax")])
    j_out = capsys.readouterr().out.splitlines()
    result = tdriver.main(common + ["--outdir", str(tmp_path / "port")])
    t_out = capsys.readouterr().out.splitlines()
    j_result = json.loads(j_out[-1])
    assert json.loads(t_out[-1]) == result
    assert result["steps"] == j_result["steps"] == 20
    assert abs(result["t"] - j_result["t"]) <= 1e-12
    assert [l for l in t_out if l.endswith(".. ok")] == ["b0.bas .. ok"]
    t_log = [l for l in t_out if l.startswith("i = ")]
    j_log = [l for l in j_out if l.startswith("i = ")]
    assert len(t_log) == len(j_log) == 20
    assert [l.split(",")[0] for l in t_log] == [l.split(",")[0]
                                                for l in j_log]
    names = same_files(tmp_path / "port", tmp_path / "jax")
    assert "psibt.bas" in names and sum(n.startswith("u0") for n in names) > 1


def test_pg_state_converts_both_ways(built):
    """A JAX state after 10 steps resumes in the port: 10 more steps there
    match 20 JAX steps; the port's leaves make a JAX PGState again."""
    import jax
    jcfg, tcfg, jc, tc = built
    jstep = jax.jit(jm.make_step(jcfg))
    js = jm.init_state(jcfg, jc, b0=b_ic(tcfg))
    for _ in range(10):
        js, _ = jstep(js, jc, jnp.asarray(1e18))
    js = jm.accumulate_means(js)
    leaves = {name: np.asarray(getattr(js, name))
              for name in convert.PG_LEAVES}
    ts = convert.pg_state_from_numpy(tcfg, leaves, device="cpu")
    back = convert.pg_state_to_numpy(ts)
    for name, value in leaves.items():
        np.testing.assert_array_equal(back[name], value)
        assert back[name].dtype == value.dtype, name
    jm.PGState(**{k: jnp.asarray(v) for k, v in back.items()})
    tstep = tm.make_step(tcfg)
    for _ in range(10):
        js, _ = jstep(js, jc, jnp.asarray(1e18))
        ts, _ = tstep(ts, tc, 1e18)
    for name in FIELDS:
        assert rel(getattr(ts, name), getattr(js, name)) < 1e-11, name
    bad = dict(leaves, b=np.zeros((3, 16, 16)))
    with pytest.raises(ValueError, match="'b'"):
        convert.pg_state_from_numpy(tcfg, bad, device="cpu")


def test_float32_model_time_reaches_events_it_cannot_represent():
    """In float32 the model time lands on f32(0.45) < 0.45 - 1e-10: the JAX
    run_pg's fixed 1e-10 never fires that output event, and every later
    step has dt = 0 until max_steps (shown below). The port's run_pg
    fires each event once, within 16 units in the last place of t, and
    never takes a step of dt = 0."""
    jcfg, tcfg = configs(dtype="float32", dtout=0.45, tend=0.9)
    const = tm.build_constants(tcfg, device="cpu")
    outs, logs = [], []
    hooks = tdriver.RunHooks(on_log=lambda *a: logs.append(a),
                             on_output=lambda st, t: outs.append(t))
    state = tdriver.run_pg(tcfg, const=const, hooks=hooks, max_steps=400)
    assert min(dt for _, dt, _, _ in logs) > 0
    assert np.allclose(outs, [0.0, 0.45, 0.9])
    assert float(state.t) == np.float32(0.9) and int(state.i) < 400
    jlogs, jouts = [], []
    js = jdriver.run_pg(jcfg, hooks=jdriver.RunHooks(
        on_log=lambda *a: jlogs.append(a),
        on_output=lambda st, t: jouts.append(t)), max_steps=len(logs))
    assert int(js.i) == len(logs) and float(js.t) == np.float32(0.45)
    # the stall is for good: from its first step of dt = 0 on, every step
    stalled = [dt == 0.0 for _, dt, _, _ in jlogs]
    first = stalled.index(True)
    assert all(stalled[first:]) and len(stalled) - first > 100
    assert jouts == [0.0]


def test_run_pg_sharded_and_cli_sharded_raise(built, tmp_path):
    """Once refused, both run at world size 1 (no process group):
    run_pg(sharded=True) is its unsharded run bit for bit through three
    output events, and `--model pg --sharded` writes the unsharded CLI's
    files byte for byte. The name is kept from when they raised."""
    _, tcfg, _, tc = built
    runs = [tdriver.run_pg(tcfg, const=tc,
                           state=tm.init_state(tcfg, tc, b0=b_ic(tcfg)),
                           sharded=sharded, device="cpu")
            for sharded in (True, False)]
    for name in FIELDS:
        assert torch.equal(getattr(runs[0], name), getattr(runs[1], name))
    assert float(runs[0].t) == pytest.approx(0.3, abs=1e-12)
    d = tmp_path / "deck"
    os.makedirs(d)
    with open(d / "params.in", "w") as f:
        f.write(PARAMS)
    from msom_tpu_torch.io.bas import write_bas
    write_bas(str(d / "b0.bas"), b_ic(TPG(N=16, nl=4)), 1.0)
    common = ["--config", str(d / "params.in"), "--model", "pg", "--cpu",
              "--steps", "20"]
    one = tdriver.main(common + ["--outdir", str(tmp_path / "a")])
    got = tdriver.main(common + ["--outdir", str(tmp_path / "b"),
                                 "--sharded"])
    assert got["ranks"] == 1 and got["steps"] == one["steps"] == 20
    names = sorted(os.listdir(tmp_path / "a"))
    assert names == sorted(os.listdir(tmp_path / "b"))
    assert sum(n.startswith("b0") for n in names) > 1
    for name in names:
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes(), name
