"""The port's fused tracer tendency
(msom_tpu_torch.models.fused_tracer.tracer_fused_reference, the plain
PyTorch version that the CUDA kernel K2 is held against on the card) against
the JAX package's Pallas tracer kernel in interpret mode
(pallas_rhs.tracer_fused) and the tracer block of qg.rhs, on identical
float64 inputs, at atol 1e-12 x max(|dtr|, 1) as tests/test_pallas_rhs.py
does; the kernel's launch geometry (its strips, grid and shared memory)
as the wrapper computes it and passes it to the launch; and the kernel's
own source, run on the CPU in tools/strip_emulation.py's host emulation of
a block, against the plain version."""

import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msom_tpu.models import pallas_rhs
from msom_tpu.models import qg as jqg
from msom_tpu.ops.ghost import ghosted, laplacian_g
from msom_tpu.params import QGConfig as JConfig
from msom_tpu_torch.models import fused_tracer
from msom_tpu_torch.models import qg as tqg
from msom_tpu_torch.ops.bc import BC as TBC
from msom_tpu_torch.ops.ghost import ghosted as tghosted
from msom_tpu_torch.ops.ghost import laplacian_g as tlaplacian_g
from msom_tpu_torch.params import QGConfig as TConfig

torch.set_num_threads(1)


def _configs(N, nl, nptr, **kw):
    base = dict(N=N, nl=nl, L0=80, Rom=0.025, Ekb=0.002, Eks=0.001,
                tau0=1e-4, Re4=391, beta=0.5,
                Fr=(0.0023669,) * (nl - 1), dh=tuple([1.0 / nl] * nl),
                DT=5e-2, tend=500.0, dtout=1.0, CFL=0.6, dtype="float64",
                solver="spectral", nptr=nptr, Pe=(1e3, 2e3, 7e2)[:nptr],
                ptr_r=(100.0, 0.0, 13.0)[:nptr])
    base.update(kw)
    return JConfig(**base).validate(), TConfig(**base).validate()


def _fields(nl, nptr, N, seed):
    rng = np.random.default_rng(seed)
    psi = 0.1 * rng.standard_normal((nl, N, N))
    tracers = rng.standard_normal((nl, nptr, N, N))
    relax = rng.standard_normal((nl, nptr, N, N))
    return psi, tracers, relax


def _check(jcfg, tcfg, psi, tracers, relax):
    jc = jqg.build_constants(jcfg, ptr_relax=relax)
    assert jc.rhsk.Ttr > 0
    p, tr = jnp.asarray(psi), jnp.asarray(tracers)
    dtr_k = pallas_rhs.tracer_fused(jcfg, jc, p, tr, interpret=True)
    psi_g = ghosted(p, jqg._bc_psi(jcfg))
    zeta = laplacian_g(psi_g, jcfg.delta)
    _, dtr_x = jqg.rhs(jcfg, jc, jqg.comp_q(jcfg, jc, p), p, psi_g, zeta,
                       jqg._ghost_deriv(jcfg, zeta, psi_g), tr)
    tc = tqg.build_constants(tcfg, device="cpu", ptr_relax=relax)
    tp, ttr = torch.as_tensor(psi), torch.as_tensor(tracers)
    dtr = fused_tracer.tracer_fused_reference(tcfg, tc, tp, ttr)
    assert dtr.shape == tracers.shape
    for want in (np.asarray(dtr_k), np.asarray(dtr_x)):
        np.testing.assert_allclose(dtr.numpy(), want, rtol=0,
                                   atol=1e-12 * max(np.abs(want).max(), 1.0))
    before = fused_tracer.launches
    assert torch.equal(fused_tracer.tracer_fused(tcfg, tc, tp, ttr), dtr)
    assert fused_tracer.launches == before       # the CPU route counts none
    # qg.rhs hands the same tendencies on beside dq
    tg = tghosted(tp, TBC.DIRICHLET)
    tz = tlaplacian_g(tg, tcfg.delta)
    _, dtr_rhs = tqg.rhs(tcfg, tc, None, tg, tz,
                         tqg._ghost_deriv(tcfg, tz, tg), ttr)
    assert torch.equal(dtr_rhs, dtr)
    return dtr.numpy()


@pytest.mark.parametrize("with_relax", [False, True])
@pytest.mark.parametrize("N,nl,nptr", [(128, 3, 2), (64, 1, 1), (64, 2, 3)])
def test_tracer_reference_matches_pallas_and_xla(N, nl, nptr, with_relax):
    jcfg, tcfg = _configs(N, nl, nptr)
    psi, tracers, relax = _fields(nl, nptr, N, N + nl + nptr)
    _check(jcfg, tcfg, psi, tracers, relax if with_relax else None)


def test_tracer_planes_keep_the_layer_tracer_order():
    """Plane (l, j) is advected by psi_l and takes tracer j's Pe and
    relaxation time: with one plane set and the others zero, only that
    plane's tendency moves, and it equals a single-tracer run of layer l
    with tracer j's coefficients."""
    N, nl, nptr = 64, 3, 2
    jcfg, tcfg = _configs(N, nl, nptr)
    psi, tracers, _ = _fields(nl, nptr, N, 3)
    tc = tqg.build_constants(tcfg, device="cpu")
    for l, j in [(0, 1), (2, 0), (1, 1)]:
        one = np.zeros_like(tracers)
        one[l, j] = tracers[l, j]
        dtr = _check(jcfg, tcfg, psi, one, None)
        mask = np.ones((nl, nptr), bool)
        mask[l, j] = False
        assert np.abs(dtr[mask]).max() == 0 and np.abs(dtr[l, j]).max() > 0
        _, c1 = _configs(N, 1, 1, Fr=(), dh=(1.0,), Pe=(tcfg.Pe[j],),
                         ptr_r=(tcfg.ptr_r[j],))
        single = fused_tracer.tracer_fused_reference(
            c1, tqg.build_constants(c1, device="cpu"),
            torch.as_tensor(psi[l:l + 1]),
            torch.as_tensor(tracers[l:l + 1, j:j + 1]))
        np.testing.assert_allclose(dtr[l, j], single[0, 0].numpy(), rtol=0,
                                   atol=1e-13 * np.abs(dtr[l, j]).max())
    assert tc.ptr_relax is None


@pytest.mark.parametrize("case", ["corner", "uniform"])
def test_tracer_wall_hazards(case):
    """Tracer ghosts are Neumann (corners +interior, no sign flip) while
    psi's are Dirichlet: a uniform tracer has no Laplacian and no gradient
    at the wall, so only its relaxation moves it."""
    N, nl, nptr = 64, 2, 2
    jcfg, tcfg = _configs(N, nl, nptr)
    psi, tracers, _ = _fields(nl, nptr, N, 8)
    if case == "corner":
        tracers[:] = 0.0
        tracers[..., 0, 0] = tracers[..., -1, -1] = 1.0
        tracers[..., 0, -1] = tracers[..., -1, 0] = -1.0
    else:
        tracers[:] = np.array([[1.0, -2.0], [0.5, 3.0]])[:, :, None, None]
    dtr = _check(jcfg, tcfg, psi, tracers, None)
    if case == "uniform":
        ir = np.asarray(tcfg.ptr_ir)[None, :, None, None]
        np.testing.assert_allclose(dtr, -ir * tracers, rtol=0, atol=1e-12)


def test_tracer_fused_never_falls_back_off_the_cpu():
    _, tcfg = _configs(32, 2, 1)
    const = tqg.build_constants(tcfg, device="cpu")
    psi = torch.empty((2, 32, 32), dtype=torch.float64, device="meta")
    tr = torch.empty((2, 1, 32, 32), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="device"):
        fused_tracer.tracer_fused(tcfg, const, psi, tr)


def test_tracer_bound_work_at_the_coupled_path():
    """2048^2 x 4 with 2 tracers in f32: psi 4 + tracers 8 in, 8 out, 20
    planes of 16.8 MB (335 MB); a relaxation field adds 8."""
    import types
    _, cfg = _configs(2048, 4, 2)
    none = types.SimpleNamespace(ptr_relax=None)
    some = types.SimpleNamespace(ptr_relax=torch.empty(0))
    assert fused_tracer.bound_work(cfg, none, 4)[0] == 20 * 2048 ** 2 * 4
    assert fused_tracer.bound_work(cfg, some, 4)[0] == 28 * 2048 ** 2 * 4


# Hopper's opt-in limit of shared memory a block (227 KB)
SMEM_OPTIN = 232448


@pytest.mark.parametrize("itemsize", [4, 8])
def test_tracer_launch_fits_shared_memory_for_every_nptr(itemsize):
    """Every nptr the kernel takes (1 to 16) fits one block's shared memory
    in f32 and f64, so none is refused."""
    for nptr in range(1, 17):
        grid, threads, smem = fused_tracer.launch_geometry(2048, 4, nptr,
                                                           itemsize)
        assert threads == fused_tracer.TX == 128
        assert 0 < smem <= SMEM_OPTIN
    # the ring: 8 rows of psi_l and each tracer, 128 + 8 columns each
    assert fused_tracer.launch_geometry(2048, 4, 2, 4)[2] == 8 * 3 * 136 * 4


@pytest.mark.parametrize("nl", [1, 4])
def test_tracer_launch_grid_at_the_coupled_width(nl):
    """At N = 2048 the grid is 16 strips across, 64 down, one layer a
    z-index."""
    assert fused_tracer.launch_geometry(2048, nl, 2, 4)[0] == (16, 64, nl)


@pytest.mark.parametrize("N", [257, 2048, 130, 48, 1])
def test_tracer_strips_cover_every_cell_once(N):
    """The strips of the grid, the last of each direction keeping the
    remainder (N = 257: one column and one row), cover each cell once."""
    (gx, gy, _), _, _ = fused_tracer.launch_geometry(N, 1, 2, 4)
    cols = fused_tracer.strips(N, fused_tracer.TX)
    rows = fused_tracer.strips(N, fused_tracer.SY)
    assert (len(cols), len(rows)) == (gx, gy)
    count = np.zeros((N, N), int)
    for y0, y1 in rows:
        for x0, x1 in cols:
            assert 0 < x1 - x0 <= fused_tracer.TX
            assert 0 < y1 - y0 <= fused_tracer.SY
            count[y0:y1, x0:x1] += 1
    assert (count == 1).all()
    if N == 257:
        assert cols[-1] == (256, 257) and rows[-1] == (256, 257)


def _emulation():
    if shutil.which("g++") is None:
        pytest.skip("the host emulation needs g++")
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    import strip_emulation
    return strip_emulation


@pytest.mark.parametrize("early", [False, True])
def test_tracer_kernel_source_in_host_emulation(tmp_path, early):
    """csrc/fused_tracer.cu itself, its copies landing at their wait or at
    their issue, matches the plain version on the CPU at N = 48, 130 and
    257 (all walls in one strip, partial strips, one-element copies), the
    template and the run-time nptr, f64 and f32, relax on and off."""
    emu = _emulation()
    lib = emu.build("shipped", early=early, out=tmp_path)
    assert emu.worst_error(lib) <= 1.0


@pytest.mark.parametrize("ring,right", [(6, True), (5, False)])
def test_tracer_ring_rule_in_host_emulation(tmp_path, ring, right):
    """The ring needs DEPTH + 3 = 6 rows: with 5, a row's copy, landing at
    its issue, overwrites a row that the step still reads."""
    emu = _emulation()
    lib = emu.build(f"ring{ring}", emu.ring_patch(ring), early=True,
                    out=tmp_path)
    assert (emu.worst_error(lib, emu.CASES[:2]) <= 1.0) == right
