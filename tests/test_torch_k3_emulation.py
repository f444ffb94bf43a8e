"""K3's strip march (msom_tpu_torch/csrc/mg_sweep.cu) and K4's
(csrc/mg_residual.cu) in tools/k3_emulation.py's host emulation: the
kernels' own source, compiled by g++ with a block's threads as fibers and
cp.async as a copy landing at its wait or at its issue. Without the fma
the emulated K3 computes the plain version's arithmetic term for term, so
a launch of k sweeps must equal k plain sweeps BIT FOR BIT, on partial
strips (n = 100, 130, 257) at k = 1 and KMAX; the ring one row short must
go wrong. The builds start together (about 8 s); each case takes well
under a second."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import k3_emulation as emu  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    out = tmp_path_factory.mktemp("k3_emulation")
    jobs = {"shipped": emu.start("shipped", out=out, opt="-O0"),
            "reverse": emu.start("reverse", out=out, opt="-O0",
                                 reverse=True),
            "rows64": emu.start("rows64", patches=emu.rows_patch(64),
                                out=out, opt="-O0"),
            "ring_short": emu.start("ring_short",
                                    patches=emu.short_ring_patch(),
                                    early=True, out=out, opt="-O0",
                                    reverse=True),
            "residual": emu.start("residual", "mg_residual", out=out,
                                  opt="-O0")}
    paths = {name: emu.finish(job) for name, job in jobs.items()}
    libs = {name: emu.load(path, "mg_residual" if name == "residual"
                           else "mg_sweep") for name, path in paths.items()}
    # the strip's sweeps a launch, as the source has them
    assert libs["shipped"].mg_sweep_per_launch(1024, 4, 4, 0) == emu.KMAX
    return libs


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n,nl", emu.SWEEP_CASES)
@pytest.mark.parametrize("k", [1, emu.KMAX])
def test_strip_launch_is_k_plain_sweeps_bit_for_bit(libs, dtype, n, nl, k):
    assert emu.sweep_mismatch(libs["shipped"], n, nl, dtype, k) == 0


@pytest.mark.parametrize("case", ["reverse", "interior", "whole",
                                  "periodic_x"])
def test_other_orders_and_forms_are_plain_sweeps_bit_for_bit(libs, case):
    """The threads taking their turns last to first; 64-row strips, some
    with no wall within reach; a whole level (one block, 7 sweeps);
    periodic_x (x wraps, rows 7 and n - 8)."""
    if case == "reverse":
        bad = emu.sweep_mismatch(libs["reverse"], 130, 4, "float32",
                                 emu.KMAX)
    elif case == "interior":
        bad = emu.sweep_mismatch(libs["rows64"], *emu.INTERIOR, "float64",
                                 emu.KMAX)
    elif case == "whole":
        bad = emu.sweep_mismatch(libs["shipped"], 32, 4, "float64", 7,
                                 modal=True)
    else:
        bad = emu.sweep_mismatch(libs["shipped"], 64, 3, "float64", 1,
                                 periodic_x=True)
    assert bad == 0


def test_a_ring_one_row_short_goes_wrong(libs):
    assert emu.sweep_mismatch(libs["ring_short"], 130, 2, "float64",
                              emu.KMAX) > 0


@pytest.mark.parametrize("n,nl,periodic_x", [(130, 4, False),
                                             (64, 3, True)])
def test_residual_march_and_its_one_launch_maximum(libs, n, nl, periodic_x):
    err, merr = emu.residual_error(libs["residual"], n, nl, "float64",
                                   periodic_x=periodic_x)
    assert err <= emu.RES_LIMIT["float64"]
    assert merr <= emu.RES_LIMIT["float64"]
    nan, _ = emu.residual_error(libs["residual"], 100, 3, "float32",
                                nan_at=(1, 50, 99))
    assert nan == 0.0
