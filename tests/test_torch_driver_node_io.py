"""The port's qg-node driver I/O and command line against the JAX
package, in float64 on the CPU (float32 for the event-time fault):
io/netcdf.NCWriter byte for byte against msom_tpu.io.netcdf's after three
appends (layered, with a surface field, cell-centred) and with no record;
the bytes each append writes (the JAX writer's k-th append writes k
records); io/deck.load_node_deck against msom_tpu.io.deck's; driver_node.main
against msom_tpu.driver_node.main on one deck directory (vars.nc within
float32 rounding, diag_1d.dat to its printed digits, the backups byte for
byte); --sharded (newqg and sqg ignore it, the qg-node model runs the
vertex-sharded step) against the unsharded runs, and the periodic
refusal; and the float32 event-time fault of the JAX run_node, which the
port does not have."""

import os

import numpy as np
import pytest
import torch

import scipy.io._netcdf as scipy_netcdf
from scipy.io import netcdf_file

from msom_tpu import driver_node as jdn
from msom_tpu.io import deck as jdeck
from msom_tpu.io import netcdf as jnc
from msom_tpu.models import qg_node as jqn
from msom_tpu_torch import driver_node as tdn
from msom_tpu_torch.io import deck as tdeck
from msom_tpu_torch.io import netcdf as tnc
from msom_tpu_torch.models import qg_node as tqn

from test_torch_driver_newqg_sqg import NEWQG_DECK, SQG_DECK
from test_torch_driver_node import _kw, _psi0, same_vars_nc

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# NetCDF and the deck
# ---------------------------------------------------------------------------

WRITERS = {
    "layered": (("psi", "q"), dict(nl=3, vertex=True, surface_vars=("bs",)),
                {"psi": (3, 17, 17), "q": (3, 17, 17)}),
    "surface": (("psi", "q", "bs"), dict(nl=2, vertex=True,
                                         surface_vars=("bs",)),
                {"psi": (2, 17, 17), "q": (2, 17, 17), "bs": (17, 17)}),
    "cells": (("psi",), dict(nl=None, L0=80.0, x0=1.0, y0=-2.0),
              {"psi": (16, 16)}),
}


@pytest.mark.parametrize("kind", list(WRITERS))
def test_ncwriter_writes_jax_bytes(tmp_path, kind):
    names, kw, shapes = WRITERS[kind]
    rng = np.random.default_rng(6)
    writers = [w.NCWriter(str(tmp_path / f"{tag}.nc"), names, 16, **kw)
               for tag, w in (("t", tnc), ("j", jnc))]
    for k in range(3):
        fields = {n: rng.standard_normal(s) for n, s in shapes.items()}
        for w in writers:
            w.append(0.25 * k + 0.1, **fields)
    for w in writers:
        w.close()
    assert (tmp_path / "t.nc").read_bytes() == (tmp_path / "j.nc").read_bytes()
    got, t = tnc.read_nc(str(tmp_path / "t.nc"), list(names), None)
    want, tj = jnc.read_nc(str(tmp_path / "j.nc"), list(names), None)
    np.testing.assert_array_equal(t, tj)
    for n in names:
        np.testing.assert_array_equal(got[n], want[n])
        assert got[n].shape == (3,) + shapes[n]


def test_ncwriter_without_records_writes_the_header(tmp_path):
    for tag, w in (("t", tnc), ("j", jnc)):
        w.NCWriter(str(tmp_path / f"{tag}.nc"), ["psi"], 8, nl=2,
                   vertex=True).close()
    assert (tmp_path / "t.nc").read_bytes() == (tmp_path / "j.nc").read_bytes()


class _Counting:
    """A file object that counts the bytes written through it."""
    written = 0

    def __init__(self, *a, **kw):
        self._f = open(*a, **kw)

    def write(self, b):
        _Counting.written += len(b)
        return self._f.write(b)

    def __getattr__(self, name):
        return getattr(self._f, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._f.close()


def test_ncwriter_append_writes_each_record_once(tmp_path, monkeypatch):
    """The JAX writer's k-th append rewrites all k records (scipy's flush
    seeks to 0 and writes the file again), so a run's output bytes grow
    quadratically with its records; the port's append writes its record
    and the 4-byte record count. Counted on four appends of a 3 x 65^2
    psi and q record (101,404 bytes)."""
    monkeypatch.setattr(scipy_netcdf, "open", _Counting, raising=False)
    monkeypatch.setattr(tnc, "open", _Counting, raising=False)
    shape = (3, 65, 65)
    rec = 4 + 2 * 4 * int(np.prod(shape))
    per_append = {}
    for tag, w in (("t", tnc), ("j", jnc)):
        wr = w.NCWriter(str(tmp_path / f"{tag}.nc"), ["psi", "q"], 64,
                        nl=3, vertex=True)
        sizes = []
        for k in range(4):
            before = _Counting.written
            wr.append(float(k), psi=np.ones(shape), q=np.ones(shape))
            sizes.append(_Counting.written - before)
        wr.close()
        per_append[tag] = sizes
    header = per_append["t"][0] - rec
    assert 0 < header < 1024
    assert per_append["t"][1:] == [rec + 4] * 3
    assert per_append["j"] == [header + k * rec for k in (1, 2, 3, 4)]
    assert (tmp_path / "t.nc").read_bytes() == (tmp_path / "j.nc").read_bytes()


def write_node_deck(d, cfg, seed=8, skip=()):
    """input_vars_<nl>l_N<N>.nc with every variable the reader takes but
    those in `skip` (and a static q_forcing it skips), as time-less
    NetCDF-3 variables."""
    nl, M = cfg.nl, cfg.N + 1
    rng = np.random.default_rng(seed)
    mask = tqn.coastline_mask(cfg.N)
    arrays = {"N2": 1.0 + 0.1 * rng.uniform(0, 1, (nl - 1, M, M)),
              "psi_pg": 1e-4 * rng.uniform(-1, 1, (nl, M, M)),
              "mask": mask, "topo": 1e-2 * rng.uniform(-1, 1, (M, M)),
              "q_forcing_3d": 1e-6 * rng.standard_normal((nl, M, M)),
              "q_forcing": np.ones((M, M))}
    arrays = {k: v for k, v in arrays.items() if k not in skip}
    path = os.path.join(d, f"input_vars_{nl}l_N{cfg.N}.nc")
    with netcdf_file(path, "w") as f:
        f.createDimension("level", nl)
        f.createDimension("interface", nl - 1)
        f.createDimension("y", M)
        f.createDimension("x", M)
        for name, a in arrays.items():
            dims = {3: ("level" if a.shape[0] == nl else "interface",
                        "y", "x"), 2: ("y", "x")}[a.ndim]
            f.createVariable(name, "f8", dims)[:] = a
    return path, arrays


def test_load_node_deck_matches_jax(tmp_path):
    cfg = tqn.NodeQGConfig(**_kw())
    path, arrays = write_node_deck(str(tmp_path), cfg)
    logged = []
    got = tdeck.load_node_deck(cfg, str(tmp_path), log=logged.append)
    want = jdeck.load_node_deck(jqn.NodeQGConfig(**_kw()), str(tmp_path))
    assert got["found"] == want["found"] == ["input_vars_3l_N32.nc"]
    assert got["path"] == want["path"] == path
    assert list(got["const"]) == list(want["const"]) == [
        "N2", "psi_pg", "mask", "topo", "q_forcing_3d"]
    for k in got["const"]:
        np.testing.assert_array_equal(got["const"][k], want["const"][k])
        np.testing.assert_array_equal(got["const"][k], arrays[k])
    assert logged == ["input_vars_3l_N32.nc .. ok (N2, mask, psi_pg, "
                      "q_forcing_3d, topo)"]
    empty = tdeck.load_node_deck(cfg, str(tmp_path / "nothing"))
    assert empty == {"const": {}, "found": [], "path": None}
    tqn.build_constants(cfg, device="cpu", **got["const"])


# ---------------------------------------------------------------------------
# the command line and what is not ported
# ---------------------------------------------------------------------------

PARAMS = """\
N  = 32
nl = 3
L0 = 100
f0 = 10
hEkb = 1e-3
tau0 = 1e-3
nu = 5
beta = 0.1
dh = [0.2, 0.3, 0.5]
N2 = [1.0, 2.0]
noise_init = 1e-3
bc_fac = 1
DT = 5.e-2
tend = 0.25
dtout = 0.125
dtdiag = 0.0625
dtflt = 0.125
Lfmax = 30
Lfmin = 10
CFL = 0.2
TOLERANCE = 1e-10
dtype = float64
"""


def test_cli_matches_jax_main(tmp_path, capfd, monkeypatch):
    """Both CLIs on one deck directory (params.in with input_vars_3l_N32.nc
    beside it: psi_pg, topography and a 3-D forcing, so the spectral
    inversion runs) and one restart.nc holding the initial psi
    (the noise IC is each package's own draw): the same vars.nc within
    float32 rounding, the same diag_1d.dat numbers to their printed
    digits, params.in, the deck's file and the restart backed up byte for
    byte, the same heartbeat lines but their last digits."""
    deck = tmp_path / "deck"
    deck.mkdir()
    (deck / "params.in").write_text(PARAMS)
    cfg = tqn.load_node_config(PARAMS)
    write_node_deck(str(deck), cfg, skip=("N2", "mask"))
    rp = tmp_path / "restart.nc"
    w = tnc.NCWriter(str(rp), ["psi", "q"], 32, nl=3, L0=100.0, vertex=True)
    psi0 = _psi0(cfg)
    w.append(0.0, psi=psi0, q=np.zeros_like(psi0))
    w.close()
    monkeypatch.chdir(tmp_path)
    common = ["--config", str(deck / "params.in"), "--cpu",
              "--restart", str(rp)]
    jdn.main(common + ["--outdir", str(tmp_path / "jax")])
    j_out = capfd.readouterr().out.splitlines()
    ts, _ = tdn.main(common + ["--outdir", str(tmp_path / "port")])
    t_out = capfd.readouterr().out.splitlines()
    assert [l for l in t_out if ".. ok" in l] == \
        [l for l in j_out if ".. ok" in l] == [
            "input_vars_3l_N32.nc .. ok (psi_pg, q_forcing_3d, topo)"]
    t_ke = [l for l in t_out if l.startswith("i = ")]
    j_ke = [l for l in j_out if l.startswith("i = ")]
    assert len(t_ke) == len(j_ke) == int(ts.i) >= 10
    assert [l.split(",")[0] for l in t_ke] == [l.split(",")[0] for l in j_ke]
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        "diag_1d.dat", "input_vars_3l_N32.nc", "params.in",
        "restart.nc.bak", "vars.nc"]
    for name in ("params.in", "input_vars_3l_N32.nc", "restart.nc.bak"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    fields, _ = same_vars_nc(str(tmp_path / "port" / "vars.nc"),
                             str(tmp_path / "jax" / "vars.nc"))
    assert fields["q"].shape == (3, 3, 33, 33)
    dat = [(tmp_path / n / "diag_1d.dat").read_text().splitlines()
           for n in ("port", "jax")]
    assert len(dat[0]) == len(dat[1]) == 5
    vals = [np.array([[float(v) for v in l.split(",")] for l in d[1:]])
            for d in dat]
    np.testing.assert_allclose(vals[0], vals[1], rtol=5e-7, atol=0)
    # the same run through run_node with the deck: the same file
    tdn.run_node(cfg, outdir=str(tmp_path / "again"), restart=str(rp),
                 deck=str(deck), params_text=PARAMS, device="cpu")
    assert (tmp_path / "again" / "vars.nc").read_bytes() == \
        (tmp_path / "port" / "vars.nc").read_bytes()


@pytest.mark.parametrize("args,match", [
    (["--model", "newqg", "--sharded"], "item 15"),
    (["--model", "sqg", "--sharded"], "item 15"),
    (["--sharded"], "item 15"),
])
def test_cli_refuses_what_is_not_ported(tmp_path, args, match):
    """Each, once refused, runs at world size 1 (no process group) and
    matches its unsharded run, three steps from the same seeded IC:
    newqg and sqg ignore --sharded, as the JAX package's main does, and
    write the same vars.nc bytes; the qg-node model runs the
    vertex-sharded step (solver = vmg in the deck, so that both runs
    invert with the multigrid): the same states bit for bit, its vars.nc
    the same bytes and diag_1d.dat the same rows. `match`, from when these
    raised, is kept only to keep the test ids."""
    model = args[1] if args[0] == "--model" else "node"
    deck = {"newqg": NEWQG_DECK, "sqg": SQG_DECK}.get(
        model, PARAMS + "solver = vmg\n")
    (tmp_path / "params.in").write_text(deck)
    common = ["--config", str(tmp_path / "params.in"), "--cpu", "--steps",
              "3", "--restart", str(tmp_path / "none.nc")]
    plain = [a for a in args if a != "--sharded"]
    one, out1 = tdn.main(common + plain + ["--outdir", str(tmp_path / "a")])
    got, out2 = tdn.main(common + args + ["--outdir", str(tmp_path / "b")])
    assert int(got.i) == int(one.i) == 3
    assert torch.equal(got.q, one.q) and torch.equal(got.psi, one.psi)
    for name in ("vars.nc", "diag_1d.dat"):
        if os.path.exists(os.path.join(out1.dir, name)):
            assert (tmp_path / "b" / name).read_bytes() == \
                (tmp_path / "a" / name).read_bytes(), name
    assert os.path.exists(tmp_path / "b" / "vars.nc")


def test_run_node_sharded_raises():
    """A periodic configuration raises the JAX package's
    NotImplementedError, message for message (vertex sharding covers
    walled grids); the name is kept from when every sharded run
    raised."""
    kw = _kw(bc_fac=-1.0)
    # JAX refuses before it reads const, state or output
    with pytest.raises(NotImplementedError) as want:
        jdn.run_node(jqn.NodeQGConfig(**kw), const=object(), state=object(),
                     output=object(), restart=None, sharded=True)
    with pytest.raises(NotImplementedError) as got:
        tdn.run_node(tqn.NodeQGConfig(**kw), sharded=True, device="cpu")
    assert str(got.value) == str(want.value)
    assert "wall domains" in str(got.value)


def test_create_outdir_picks_the_next_free_one(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    os.makedirs("outdir_0001")
    assert tdn.create_outdir(None) == "outdir_0002"
    assert tdn.create_outdir("mine") == "mine" and os.path.isdir("mine")
    out = tdn.NodeOutput(tqn.NodeQGConfig(**_kw(nl=1, dh=(1.0,))))
    assert out.dir == "outdir_0003"
    out.write(0.0, psi=torch.zeros((1, 33, 33)), q=torch.zeros((1, 33, 33)))
    out.close()
    f, _ = tnc.read_nc("outdir_0003/vars.nc", ["psi"], None)
    assert f["psi"].shape == (1, 33, 33)      # nl = 1: no level axis


def test_float32_model_time_reaches_events_it_cannot_represent(tmp_path):
    """In float32 the model time lands on f32(0.45) < 0.45 - 1e-10, so
    with the JAX driver's fixed 1e-10 (msom_tpu/driver_node.py:199-216)
    the output event never fires and every later step has dt = 0 until
    max_steps (shown on the JAX run_node below). The port fires each
    event once, within 16 units in the last place of t, and never takes a
    step of dt = 0."""
    kw = _kw(N=16, dtype="float32", dtout=0.45, dtdiag=-1.0, dtflt=0.3,
             tend=0.9, beta=0.0, DT=0.1)
    # the JAX run without the filter: the output event alone stalls it
    tcfg = tqn.NodeQGConfig(**kw)
    jcfg = jqn.NodeQGConfig(**dict(kw, dtflt=-1.0))
    psi0 = _psi0(tcfg)
    outs, flts, logs = [], [], []
    hooks = tdn.RunHooks(on_log=lambda *a: logs.append(a),
                         on_output=lambda st, t: outs.append(t),
                         on_filter=lambda st, t: flts.append(t))
    tc = tqn.build_constants(tcfg, device="cpu")
    ts, _ = tdn.run_node(tcfg, const=tc, state=tqn.init_state(
        tcfg, tc, psi0=psi0), hooks=hooks, outdir=str(tmp_path / "t"),
        restart=None, max_steps=200)
    assert int(ts.i) < 60 and min(dt for _, dt, _, _ in logs) > 0
    assert np.allclose(outs, [0.0, 0.45, 0.9])
    assert np.allclose(flts, [0.3, 0.6, 0.9])   # at tend too, as JAX's
    assert float(ts.t) == np.float32(0.9)
    jc = jqn.build_constants(jcfg)
    jlogs = []
    js, _ = jdn.run_node(jcfg, const=jc, state=jqn.init_state(
        jcfg, jc, psi0=psi0), hooks=jdn.RunHooks(
            on_log=lambda *a: jlogs.append(a)), outdir=str(tmp_path / "j"),
        restart=None, max_steps=60)
    assert int(js.i) == 60 and jlogs[-1][1] == 0.0
    assert sum(dt == 0.0 for _, dt, _, _ in jlogs) > 30
