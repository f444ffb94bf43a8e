"""The benchmark's runner: one run of one cell.

Everything that belongs to one cell, configuration, traffic mix or metric
sits in a file of its own, found by the name that BENCHMARK.json gives:

  workloads/<cell>.json     the cell: config, traffic, chips, why, the
                            limits of the numbers it compares, its control
                            (readings.py)
  configs/<config>.json     the configuration's keys as run, its source,
                            its `system` (systems/<system>.py, the adapter
                            that drives the program) and `reference`
                            (reference/<reference>.py, the plain model)
  traffic/<traffic>.json    the traffic mix, read by traffic.py
  metrics/<quantity>.py     one quantity: `read(run)` returns its value,
                            or None where it finds nothing to read; a
                            metric `<quantity>.<suffix>` (a quantity split
                            over cells that report different end-to-end
                            metrics) is read by its quantity's file

A run: set-up (the program's constants and initial state from the seed,
the spin-up and warm-up calls), the window (the mix's replay of calls of
the driver from the state that set-up left, run again until `seconds` have
passed, then a synchronise), with `trace` the traced window (the replay's
first calls) and the per-layer readers, then the comparison with the
reference, after the program's state is freed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

from portbench import check, trace, traffic

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark by its file (metric names hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    name = "_".join(("portbench", path.parent.name, path.stem))
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    spec: dict          # workloads/<cell>.json
    config: dict        # configs/<config>.json
    mix: dict           # traffic/<traffic>.json


def find_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json and its files under `root`."""
    entry = [w for w in bench["workloads"] if w["name"] == name]
    if len(entry) != 1:
        raise KeyError(f"BENCHMARK.json has no cell {name!r}")
    spec = load_json(root / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if spec[key] != entry[0][key]:
            raise ValueError(f"{name}: {key} is {entry[0][key]!r} in "
                             f"BENCHMARK.json and {spec[key]!r} in its file")
    config = load_json(root / "configs" / f"{spec['config']}.json")
    mix = traffic.check(load_json(root / "traffic" /
                                  f"{spec['traffic']}.json"))
    return Cell(name, spec, config, mix)


def reader(name: str, root: Path = ROOT):
    """The reader of metric `name`: metrics/<its quantity>.py."""
    return load_module(root / "metrics" / f"{name.split('.', 1)[0]}.py")


def metrics_of(bench: dict, cell: str, kind: str) -> list[dict]:
    """The metrics a run of `cell` reports: with kind "end_to_end" those of
    its --trace 0 line, with "per_layer" those of --trace 1; a metric with
    `workloads` is the listed cells', one without it every cell's."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


class Run:
    """What the metric readers read: the cell, the system under test and
    its final state, the window's record, the trace, and the program's
    counters."""

    def __init__(self, cell: Cell, system, device: str):
        self.cell, self.system, self.device = cell, system, device
        self.cuda = torch.device(device).type == "cuda"
        self.mix = cell.mix
        self.state = None
        self.setup_s = None
        self.window_s = None
        self.window_steps = None
        self.trace: trace.Trace | None = None
        self.trace_steps = None
        self.done = 0          # steps the program's `state` has taken

    def step_ms(self) -> float:
        """Wall milliseconds a step over the untraced window."""
        return self.window_s / self.window_steps * 1e3

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def device_ms(self, fn, n: int) -> float:
        """Mean milliseconds of fn() over n calls, between two CUDA events
        (on a CPU device, the host's clock around them)."""
        fn()
        self.sync()
        if not self.cuda:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            return (time.perf_counter() - t0) / n * 1e3
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize(self.device)
        return start.elapsed_time(end) / n

    def host_s(self, fn) -> float:
        """Seconds of fn() on the host's clock, from a synchronise to a
        synchronise."""
        self.sync()
        t0 = time.perf_counter()
        fn()
        self.sync()
        return time.perf_counter() - t0


def make_system(cell: Cell, device: str, root: Path = ROOT):
    mod = load_module(root / "systems" / f"{cell.config['system']}.py")
    return mod.System(cell.config["keys"], cell.mix["dtype"], device)


def run_cell(bench: dict, name: str, *, seed: int, seconds: float,
             trace_on: bool, device: str = "cuda", root: Path = ROOT,
             t_start: float | None = None, system=None) -> dict:
    """One run of cell `name`; returns the result's fields (correct,
    attempted, failed, metrics, device, breakdown, checks). `system`,
    where given, runs in the program's place (a control)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = find_cell(bench, name, root)
    mix = cell.mix
    seed = int(seed) % 2 ** 63
    run = Run(cell, system or make_system(cell, device, root), device)
    res = _measure(bench, run, seed, seconds, trace_on, root, t_start)
    run.system.release()
    run.state = None
    gc.collect()
    if run.cuda:
        torch.cuda.empty_cache()
    ref = load_module(root / "reference" / f"{cell.config['reference']}.py")
    model = ref.Model(cell.config["keys"], dtype=torch.float64,
                      device=device)
    per_item = check.compare(model, res.pop("items"),
                             mix["steps_per_call"], res.pop("psi0"))
    failed, shown = check.judge(per_item, cell.spec["limits"])
    res.update(correct=failed == 0, attempted=len(per_item), failed=failed,
               numbers={k: max(it[k] for it in per_item)
                        for k in per_item[0]},
               checks=shown)
    return res


def _measure(bench, run: Run, seed, seconds, trace_on, root, t_start):
    cell, mix, system = run.cell, run.mix, run.system
    K = mix["steps_per_call"]
    keys = cell.config["keys"]
    psi0 = traffic.initial_field(mix, (keys["nl"], keys["N"], keys["N"]),
                                 seed, run.device)
    state = system.start(psi0)
    # set-up: the first call, from the initial state, is checked from the
    # reference's own; then the rest of the spin-up and the warm-up
    items = []
    done = 0
    for c in range(traffic.calls_before_window(mix)):
        state = system.call(state, K, done)
        done += K
        if c == 0:
            items.append((None, system.snapshot(state)))
    # every replay of the window, and the traced calls, start here
    start, start_done = state, system.steps_done(state)
    run.sync()
    run.setup_s = time.perf_counter() - t_start

    sampler = traffic.Sampler(mix["samples"], seed)
    counting = system.counting() if trace_on else contextlib.nullcontext()
    calls = steps = 0
    with counting:
        run.sync()
        t0 = time.perf_counter()
        while True:
            state, done = start, start_done
            for _ in range(mix["replay_calls"]):
                slot = sampler.offer(calls)
                before = system.snapshot(state) if slot is not None else None
                state = system.call(state, K, done)
                now = system.steps_done(state)
                steps += now - done
                done = now
                if slot is not None:
                    sampler.keep(slot, (before, system.snapshot(state)))
                calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        run.sync()
        run.window_s = time.perf_counter() - t0
    run.window_steps = steps
    items += sampler.items()
    peak = torch.cuda.max_memory_allocated(run.device) if run.cuda else 0

    run.state, run.done = state, done
    res = {"psi0": psi0, "items": items}
    if trace_on:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        act = ProfilerActivity.CUDA if run.cuda else ProfilerActivity.CPU
        state, done = start, start_done
        with profile(activities=[act]) as prof:
            run.sync()
            t0 = time.perf_counter()
            for _ in range(mix["trace_calls"]):
                state = system.call(state, K, done)
                done += K
            run.sync()
            window_s = time.perf_counter() - t0
        run.trace = trace.reduce(prof.events(), DeviceType.CUDA, window_s)
        run.state, run.done = state, system.steps_done(state)
        run.trace_steps = run.done - start_done
        res["breakdown"] = {"device_ops": run.trace.device_ops,
                            "idle_gaps": run.trace.idle_gaps}
    kind = "per_layer" if trace_on else "end_to_end"
    metrics = {}
    for m in metrics_of(bench, cell.name, kind):
        value = reader(m["name"], root).read(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    res["metrics"] = metrics
    res["device"] = device_record(run, peak)
    return res


def device_record(run: Run, peak: int) -> dict:
    if run.cuda:
        kind = torch.cuda.get_device_name(run.device)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    rec = {"platform": platform, "kind": kind,
           "count": run.cell.spec["chips"], "memory_peak_bytes": peak}
    if run.trace is not None:
        rec["busy_s"] = run.trace.busy_s
        rec["window_s"] = run.trace.window_s
    return rec
