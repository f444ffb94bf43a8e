"""The harness on the CPU: both cells' plumbing through run_qg at a small
grid, the refusal without a card, files found by name, and the rules on
BENCHMARK.json's names and units."""

import json
import re
import shutil

import pytest
import torch

from conftest import REPO, bench, mg_cell, small_root
from portbench import harness, traffic

CELLS = [w["name"] for w in bench()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_dry_run_of_each_cell(cell, small):
    """A run at N = 32 on the CPU drives run_qg through set-up, the window
    and the comparison; the program agrees with the reference within the
    cell's limits, and the end-to-end metrics come out."""
    res = harness.run_cell(bench(), cell, seed=2 ** 31 + 11, seconds=0.2,
                           trace_on=False, device="cpu", root=small)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert set(res["metrics"]) == {
        m["name"] for m in harness.metrics_of(bench(), cell, "end_to_end")}
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["numbers"]["steps_off"] == 0
    assert res["device"]["platform"] == "cpu"


def test_traced_dry_run(small):
    """--trace 1's path on the CPU: the traced window, the trace's
    reduction and the readers; device-time readers find nothing to read
    without a card and return nothing."""
    cell = mg_cell()
    res = harness.run_cell(bench(), cell, seed=5, seconds=0.2, trace_on=True,
                           device="cpu", root=small)
    assert res["correct"], res["checks"]
    names = {m["name"] for m in harness.metrics_of(bench(), cell,
                                                   "per_layer")}
    assert set(res["metrics"]) <= names
    assert res["metrics"]["mg_vcycles"]["value"] >= 1
    # the readers of device time find nothing to read on the CPU
    assert set(res["metrics"]) == {"mg_vcycles"}
    assert res["device"]["window_s"] > 0 and res["device"]["busy_s"] == 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


class _Recording:
    """The program, recording each call's first step and its final q."""

    def __init__(self, system):
        self.system, self.calls = system, []

    def __getattr__(self, name):
        return getattr(self.system, name)

    def call(self, state, steps, done):
        state = self.system.call(state, steps, done)
        self.calls.append((done, state.q.clone()))
        return state


@pytest.mark.parametrize("seconds", [0.0, 0.3])
def test_the_window_is_whole_replays_of_the_same_calls(seconds, small):
    """The window runs the mix's replay from the state set-up left, again
    and again, and ends at a replay's end: each replay makes the same
    calls with the same answers, so a step's work does not depend on how
    many steps the window holds."""
    cell = mg_cell()
    spec = harness.find_cell(bench(), cell, small)
    system = _Recording(harness.make_system(spec, "cpu", small))
    res = harness.run_cell(bench(), cell, seed=31, seconds=seconds,
                           trace_on=False, device="cpu", root=small,
                           system=system)
    assert res["correct"], res["checks"]
    R = spec.mix["replay_calls"]
    before = traffic.calls_before_window(spec.mix)
    window = system.calls[before:]
    assert window and len(window) % R == 0
    first = window[:R]
    assert [d for d, _ in first] == [
        before * spec.mix["steps_per_call"] + k * spec.mix["steps_per_call"]
        for k in range(R)]
    for r in range(1, len(window) // R):
        again = window[r * R:(r + 1) * R]
        assert [d for d, _ in again] == [d for d, _ in first]
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(again, first))


def test_t_err_is_the_calls_own_advance():
    """t_err compares what a call adds to the model time, so an error in
    it reads the same however late in the run the call comes."""
    from portbench import check
    for t0 in (0.0, 2.5, 1000.0):
        assert check._advance_err(t0 + 1.01, t0 + 1.0, t0) == \
            pytest.approx(0.01, rel=1e-9)
    assert check._advance_err(3.0, 4.0, 3.0) == 1.0


def test_same_seed_same_inputs():
    a = traffic.initial_field({"ic": {"kind": "uniform", "amplitude": 1e-3},
                               "dtype": "float32"}, (2, 8, 8), 2 ** 31 + 3,
                              "cpu")
    b = traffic.initial_field({"ic": {"kind": "uniform", "amplitude": 1e-3},
                               "dtype": "float32"}, (2, 8, 8), 2 ** 31 + 3,
                              "cpu")
    assert torch.equal(a, b) and float(a.abs().max()) <= 1e-3


def test_sampler_keeps_k_of_any_window():
    for n in (1, 3, 7, 100):
        s = traffic.Sampler(3, 42)
        for c in range(n):
            slot = s.offer(c)
            if slot is not None:
                s.keep(slot, c)
        kept = s.items()
        assert len(kept) == min(3, n) and len(set(kept)) == len(kept)


def test_no_card_no_result(monkeypatch, capsys):
    """The measurement path needs a card: without one it exits with an
    error and prints no result, and runs nothing on the CPU."""
    import portbench.run as run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    called = []
    monkeypatch.setattr(harness, "run_cell",
                        lambda *a, **k: called.append(1))
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and not called
    assert "{" not in out.out


def test_run_outside_a_checkout_fails(tmp_path):
    """In a folder that holds only BENCHMARK.json and the benchmark's files
    the program is missing: the run exits non-zero and prints nothing on
    its standard output."""
    import subprocess
    import sys
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    # what the run would find without a card, and with the program absent
    code = ("import sys, torch; torch.cuda.is_available = lambda: True;"
            "torch.cuda.device_count = lambda: 1;"
            "sys.argv = ['run.py', '--workload', %r, '--seed', '1',"
            "'--seconds', '1'];"
            "sys.path.insert(0, 'portbench');"
            "import runpy; runpy.run_path('portbench/run.py',"
            " run_name='__main__')") % CELLS[0]
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "msom_tpu_torch" in p.stderr


def test_added_files_are_found_without_an_edit(tmp_path):
    """A cell, a configuration, a traffic mix and a metric added as files
    (and as entries of BENCHMARK.json) run with no edit of the harness."""
    root = small_root(tmp_path / "portbench")
    b = bench()
    cfg = json.loads((root / "configs" / "msqg_dg_2048.json").read_text())
    cfg["name"] = "msqg_dg_new"
    cfg["keys"]["nl"] = 2
    cfg["keys"]["dh"] = [0.2, 0.8]
    cfg["keys"]["Fr"] = [0.005]
    (root / "configs" / "msqg_dg_new.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "f32_from_rest.json").read_text())
    mix["steps_per_call"] = 5
    (root / "traffic" / "short_calls.json").write_text(json.dumps(mix))
    spec = {"config": "msqg_dg_new", "traffic": "short_calls", "chips": 1,
            "why": "an added cell", "control": {"program_tf32": True},
            "limits": {"q_err": 0.1, "steps_off": 0}}
    (root / "workloads" / "msqg_dg_new.short.json").write_text(
        json.dumps(spec))
    (root / "metrics" / "calls_made.py").write_text(
        "def read(run):\n"
        "    return run.window_steps / run.mix['steps_per_call']\n")
    b["configs"].append({"name": "msqg_dg_new", "source": "a test",
                         "file": "portbench/configs/msqg_dg_new.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "msqg_dg_new.short",
                           "config": "msqg_dg_new",
                           "traffic": "short_calls", "chips": 1,
                           "why": "an added cell"})
    b["end_to_end"].append({"name": "calls_made", "unit": "calls",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["msqg_dg_new.short"]})
    res = harness.run_cell(b, "msqg_dg_new.short", seed=9, seconds=0.2,
                           trace_on=False, device="cpu", root=root)
    assert res["correct"], res["checks"]
    assert res["metrics"]["calls_made"]["value"] >= 1
    # the other cells do not report the new cell's metric
    assert "calls_made" not in {
        m["name"] for m in harness.metrics_of(b, CELLS[0], "end_to_end")}


# -- BENCHMARK.json against the rules on its form --------------------------

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_names_and_units():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(b["command"]) <= 32
    assert all(TEXT.match(w) for w in b["command"])
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/")
        assert (REPO / c["file"]).is_file()
        names.append(c["name"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert TEXT.match(w["why"])
        pairs.add((w["config"], w["traffic"]))
        names.append(w["name"])
    assert len(pairs) == len(b["workloads"])
    layers = set()
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            allowed = {"name", "unit", "better", "source", "workloads"} | (
                {"bound"} if kind == "end_to_end" else {"layer", "moves"})
            assert set(m) <= allowed and set(m) >= allowed - {"workloads"}
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
            if kind == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert TEXT.match(m["layer"])
                assert m["moves"] in {e["name"] for e in b["end_to_end"]}
                layers.add(m["layer"])
            names.append(m["name"])
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}


def test_every_name_has_its_file():
    """Each cell, configuration, traffic mix and metric of BENCHMARK.json
    has its file, and each cell's file agrees with its entry."""
    b = bench()
    pb = REPO / "portbench"
    for w in b["workloads"]:
        spec = json.loads((pb / "workloads" / f"{w['name']}.json")
                          .read_text())
        assert {k: spec[k] for k in ("config", "traffic", "chips", "why")} \
            == {k: w[k] for k in ("config", "traffic", "chips", "why")}
        traffic.check(json.loads((pb / "traffic" / f"{w['traffic']}.json")
                                 .read_text()))
        assert spec["limits"] and spec["control"]
    for c in b["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert (pb / "systems" / f"{cfg['system']}.py").is_file()
        assert (pb / "reference" / f"{cfg['reference']}.py").is_file()
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            quantity = m["name"].split(".", 1)[0]
            assert (pb / "metrics" / f"{quantity}.py").is_file()
    for w in b["workloads"]:
        got = {m["name"] for m in harness.metrics_of(b, w["name"],
                                                     "per_layer")}
        assert got, w["name"]


def test_trace_reduction_on_a_known_timeline():
    """Busy time is the union of the device operations; each gap between
    two is named after the host's CUDA call open at its middle, and the
    rest of the window is its edges."""
    from types import SimpleNamespace as NS

    from portbench import trace
    CPU, DEV = "cpu", "dev"

    def ev(name, a, b, dev=CPU):
        return NS(name=name, device_type=dev,
                  time_range=NS(start=a, end=b))

    events = [
        ev("cudaMemcpyAsync", 25, 44), ev("cudaLaunchKernel", 60, 62),
        ev("k_a", 5, 20, DEV), ev("k_b", 15, 30, DEV),
        ev("Memcpy DtoH", 45, 50, DEV), ev("k_a", 80, 90, DEV),
    ]
    t = trace.reduce(events, DEV, window_s=100e-6)
    assert t.busy_s == pytest.approx((25 + 5 + 10) * 1e-6)
    assert t.kernels == 3
    assert t.device_ops[0] == ["k_a", pytest.approx(25e-6)]
    gaps = dict(t.idle_gaps)
    assert gaps["cudaMemcpyAsync"] == pytest.approx(15e-6)   # 30-45
    assert gaps["host"] == pytest.approx(30e-6)              # 50-80
    assert gaps["window edges"] == pytest.approx(15e-6)
