"""The comparison fails what it should: a run with the timed path broken
underneath (the harness's look for a card skipped, everything else as a
run), and each cell's control, come out not correct."""

import json

import pytest
import torch

from conftest import bench, small_root
from msom_tpu_torch.models import qg
from portbench import harness, readings

CELLS = [w["name"] for w in bench()["workloads"]]


def _broken(fault):
    """A make_step whose step has `fault`."""
    make_step = qg.make_step

    def make(cfg, generator=None):
        step = make_step(cfg, generator)

        def broken(state, const, tnext):
            if fault == "unchanged":
                # the state returned as it came, only its counter moved on
                _, diag = step(state, const, tnext)
                return qg.QGState(**{**vars(state), "i": state.i + 1}), diag
            new, diag = step(state, const, tnext)
            q = new.q.clone()
            N = q.shape[-1]
            if fault == "altered":
                # one value of the answer changed where it is produced
                q[0, N // 2, N // 2] += 1e-2 * q.abs().max()
            elif fault == "half":
                # half of the domain left where it was
                q[..., N // 2:, :] = state.q[..., N // 2:, :]
            return qg.QGState(**{**vars(new), "q": q}), diag
        return broken
    return make


@pytest.mark.parametrize("fault", ["unchanged", "altered", "half"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_not_correct(cell, fault, tmp_path, monkeypatch):
    root = small_root(tmp_path / "portbench")
    monkeypatch.setattr(qg, "make_step", _broken(fault))
    res = harness.run_cell(bench(), cell, seed=17, seconds=0.1,
                           trace_on=False, device="cpu", root=root)
    assert not res["correct"], res["checks"]
    assert res["failed"] >= 1


def test_a_sound_run_at_the_same_size_is_correct(tmp_path):
    root = small_root(tmp_path / "portbench")
    for cell in CELLS:
        res = harness.run_cell(bench(), cell, seed=17, seconds=0.1,
                               trace_on=False, device="cpu", root=root)
        assert res["correct"], (cell, res["checks"])


def _control(cell):
    return json.loads((harness.ROOT / "workloads" / f"{cell}.json")
                      .read_text())["control"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_bfloat16_reference_is_not_correct(cell, tmp_path):
    """The plain reference computed in bfloat16, in the program's place at
    N = 32, fails every cell's limits."""
    root = small_root(tmp_path / "portbench")
    spec = harness.find_cell(bench(), cell, root)
    system = readings.ReferenceSystem(spec, "cpu", torch.bfloat16, root)
    res = harness.run_cell(bench(), cell, seed=23, seconds=0.1,
                           trace_on=False, device="cpu", root=root,
                           system=system)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c for c in CELLS
                                  if "reference_dtype" in _control(c)])
def test_the_reference_control_is_not_correct(cell):
    """The cell's control, the plain reference in the type its file names,
    in the program's place at the cell's own size (one replay), fails the
    cell's limits: a float32 reference passes them at a small grid, where
    round-off through the hyperviscosity is small."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    res = readings.control_run(bench(), cell, seed=41, seconds=0.0,
                               device="cuda")
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c for c in CELLS
                                  if "program_tf32" in _control(c)])
def test_the_tf32_control_is_not_correct(cell, tmp_path):
    """The program with TF32 on in its matrix products, at N = 512 (the
    folded transform's smallest), fails the cell's limits; with TF32 off
    it meets them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    root = small_root(tmp_path / "portbench", N=512)
    res = readings.control_run(bench(), cell, seed=29, seconds=1.0,
                               device="cuda", root=root)
    assert not res["correct"], res["checks"]
    res = harness.run_cell(bench(), cell, seed=29, seconds=1.0,
                           trace_on=False, device="cuda", root=root)
    assert res["correct"], res["checks"]
