"""What a run loads: after a dry run of a cell, no module whose top-level
name is jax, jaxlib, flax or msom_tpu (the JAX package the port was made
from); the reference loads nothing of the port. Names are compared whole,
so msom_tpu_torch is not msom_tpu."""

import json
import subprocess
import sys

from conftest import REPO, bench

DRY_RUN = """
import json, sys, tempfile
from pathlib import Path
sys.path.insert(0, {repo!r}); sys.path.insert(0, {tests!r})
import conftest
from portbench import harness
import portbench.run as run
root = conftest.small_root(Path(tempfile.mkdtemp()) / "portbench")
res = harness.run_cell(conftest.bench(), {cell!r}, seed=3, seconds=0.1,
                       trace_on=False, device="cpu", root=root)
assert res["correct"]
print(json.dumps({{"top": sorted({{m.split(".")[0] for m in sys.modules}}),
                  "forbidden": run.forbidden_modules()}}))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {repo!r})
import torch
from portbench.reference import msqg
cfg = json.loads(open({cfg!r}).read())
keys = dict(cfg["keys"], N=16)
m = msqg.Model(keys, dtype=torch.float64)
st = m.advance(m.initial(1e-3 * torch.rand(3, 16, 16, dtype=torch.float64)),
               2)
assert st.i == 2
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _run(code: str):
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=REPO)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_no_jax_package():
    for cell in (w["name"] for w in bench()["workloads"]):
        got = _run(DRY_RUN.format(repo=str(REPO),
                                  tests=str(REPO / "portbench" / "tests"),
                                  cell=cell))
        assert "msom_tpu_torch" in got["top"]
        assert not {"jax", "jaxlib", "flax", "msom_tpu"} & set(got["top"])
        assert got["forbidden"] == []


def test_the_reference_loads_nothing_of_the_port():
    got = _run(REFERENCE.format(
        repo=str(REPO),
        cfg=str(REPO / "portbench" / "configs" / "msqg_dg_2048.json")))
    assert "torch" in got
    assert not {"msom_tpu_torch", "msom_tpu", "jax"} & set(got)


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    import portbench.run as run
    monkeypatch.setitem(sys.modules, "msom_tpu_torch_x", sys)
    assert "msom_tpu_torch_x" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]
