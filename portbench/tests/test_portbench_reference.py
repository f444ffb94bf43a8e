"""The plain reference against the port in float64 at small grids, both
solvers, on the same configuration and initial field; and the frozen work
arithmetic against the port's own count. (The reference itself imports
nothing of the port; these tests import both.)"""

import json

import numpy as np
import pytest
import torch

from conftest import REPO, bench
from msom_tpu_torch.models import fused_rhs, qg
from msom_tpu_torch.params import QGConfig
from portbench import work
from portbench.reference import msqg

CONFIGS = [c["name"] for c in bench()["configs"]]


def _keys(name, N):
    c = json.loads((REPO / "portbench" / "configs" / f"{name}.json")
                   .read_text())
    k = dict(c["keys"], N=N, Re4=1563.0 * (N / 256) ** 3 * 64)
    if k["solver"] == "mg":
        k["tol"] = 1e-13        # solved to round-off: the exact solution
    return k


def _port_cfg(keys):
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in keys.items()}
    return QGConfig(**kw, dtype="float64").validate()


def _psi0(N, seed=4):
    g = torch.Generator().manual_seed(seed)
    return 1e-3 * (2 * torch.rand((3, N, N), generator=g,
                                  dtype=torch.float64) - 1)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("N", [16, 32])
def test_reference_follows_the_port_in_f64(name, N):
    keys = _keys(name, N)
    cfg = _port_cfg(keys)
    const = qg.build_constants(cfg, device="cpu")
    psi0 = _psi0(N)
    st = qg.init_state(cfg, const, psi0=psi0)
    model = msqg.Model(keys, dtype=torch.float64)
    ref = model.initial(psi0)
    assert torch.allclose(st.q, ref.q, rtol=0, atol=1e-13 * ref.q.abs().max())
    step = qg.make_step(cfg)
    for _ in range(6):
        st, _ = step(st, const, cfg.tend)
        ref = model.step(ref)
    # the multigrid stops at a residual of 1e-13, which leaves psi a few
    # 1e-10 of its size off the exact solution; the spectral solve is exact
    lim = 1e-8 if keys["solver"] == "mg" else 1e-11
    for a, b in ((st.q, ref.q), (st.psi, ref.psi)):
        assert float((a - b).abs().max() / b.abs().max()) < lim
    assert abs(float(st.t) - float(ref.t)) < 1e-12 * float(ref.t)
    assert abs(float(st.dt_prev) - float(ref.dt_prev)) < 1e-12
    assert int(st.i) == ref.i == 6


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_inversion_is_exact(name):
    """The reference's dense DST-II inversion inverts its own q."""
    keys = _keys(name, 32)
    m = msqg.Model(keys, dtype=torch.float64)
    psi = _psi0(32, 8)
    assert float((m.invert(m.comp_q(psi)) - psi).abs().max()) < 1e-14


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_frozen_k1_work_matches_the_port(name, dtype):
    keys = _keys(name, 64)
    cfg = _port_cfg(keys)
    const = qg.build_constants(cfg, device="cpu")
    size = torch.finfo(dtype).bits // 8
    got = work.k1_work(cfg.N, cfg.nl, size, iRe=cfg.iRe, iRe4=cfg.iRe4)
    assert got == fused_rhs.bound_work(cfg, const, size)


def test_step_work_counts_two_tendencies_and_the_transforms():
    N, nl = 2048, 3
    nbytes, ops = work.step_work(N, nl, 4, iRe=0.0, iRe4=-1e-6)
    _, k1 = work.k1_work(N, nl, 4, iRe=0.0, iRe4=-1e-6)
    M = 2 * N + 2
    solve = 4 * nl * nl * N * N + nl * 4 * N * 2.5 * M * np.log2(M) \
        + nl * N * N
    assert nbytes == 7 * nl * N * N * 4
    assert ops == pytest.approx(2 * (k1 + 2 * nl * N * N + solve))
    # the least time is a few percent of the step measured on the card
    assert 0.05e-3 < work.least_seconds(nbytes, ops, 4) < 0.5e-3
