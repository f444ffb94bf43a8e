"""Shared helpers of the benchmark's own tests (CPU; the `cuda` tests run
on a card). Run from the root of the checkout:

    python -m pytest portbench/tests -q
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# the folders a run reads, by name
FOLDERS = ("configs", "workloads", "traffic", "metrics", "systems",
           "reference")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card and nvcc; skips without a card")


def bench() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def mg_cell() -> str:
    """The first cell of BENCHMARK.json whose configuration solves by
    multigrid."""
    for w in bench()["workloads"]:
        cfg = json.loads((REPO / "portbench" / "configs" /
                          f"{w['config']}.json").read_text())
        if cfg["keys"]["solver"] == "mg":
            return w["name"]
    raise LookupError("BENCHMARK.json has no multigrid cell")


def small_root(dst: Path, N: int = 32, spinup_calls: int = 1) -> Path:
    """A copy of the benchmark's folders at grid N (the hyperviscosity
    scaled so that dt stays near the cells'), with at most `spinup_calls`
    calls of spin-up."""
    for d in FOLDERS:
        shutil.copytree(REPO / "portbench" / d, dst / d)
    for f in (dst / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["keys"]["N"] = N
        c["keys"]["Re4"] = 1563.0 * (N / 256) ** 3 * 64
        f.write_text(json.dumps(c))
    for f in (dst / "traffic").glob("*.json"):
        m = json.loads(f.read_text())
        m["spinup_steps"] = min(m["spinup_steps"],
                                spinup_calls * m["steps_per_call"])
        f.write_text(json.dumps(m))
    return dst


@pytest.fixture
def small(tmp_path):
    return small_root(tmp_path / "portbench")
