"""The port's fused tendency (msom_tpu_torch.models.fused_rhs) on the CPU,
where it is the plain PyTorch version, against the JAX package's Pallas
kernel in interpret mode (pallas_rhs.rhs_fused) and against its XLA
lowering (qg.rhs), on identical float64 inputs.

Tolerances are those of tests/test_pallas_rhs.py: dq at atol
1e-12 x max(|dq|, 1), the per-layer face-speed maxima at rtol 1e-13. The
CUDA kernel itself is held against this plain version on the card by
chip_smoke.py."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msom_tpu.models import pallas_rhs
from msom_tpu.models import qg as jqg
from msom_tpu.ops.ghost import ghosted, laplacian_g, max_face_speed_layers
from msom_tpu.params import QGConfig as JConfig
from msom_tpu_torch.models import fused_rhs
from msom_tpu_torch.models import qg as tqg
from msom_tpu_torch.params import QGConfig as TConfig

torch.set_num_threads(1)


def _configs(N, nl, Re, **kw):
    base = dict(N=N, nl=nl, L0=80, Rom=0.025, Ekb=0.002, Eks=0.001,
                tau0=1e-4, Re4=391, Re=Re, beta=0.5,
                Fr=(0.0023669,) * (nl - 1), dh=tuple([1.0 / nl] * nl),
                DT=5e-2, tend=500.0, dtout=1.0, CFL=0.6, dtype="float64",
                solver="spectral")
    base.update(kw)
    return JConfig(**base).validate(), TConfig(**base).validate()


def _jax_rhs(jcfg, psi):
    """(dq from the Pallas kernel in interpret mode, dq from qg.rhs, umax)."""
    const = jqg.build_constants(jcfg)
    assert pallas_rhs.applicable(jcfg, const)
    p = jnp.asarray(psi)
    dq_k, umax_k = pallas_rhs.rhs_fused(jcfg, const, p, interpret=True)
    psi_g = ghosted(p, jqg._bc_psi(jcfg))
    zeta = laplacian_g(psi_g, jcfg.delta)
    zeta_g = jqg._ghost_deriv(jcfg, zeta, psi_g)
    dq_x, _ = jqg.rhs(jcfg, const, jqg.comp_q(jcfg, const, p), p, psi_g,
                      zeta, zeta_g, None)
    np.testing.assert_allclose(np.asarray(umax_k),
                               np.asarray(max_face_speed_layers(
                                   psi_g, jcfg.delta)), rtol=1e-13, atol=0)
    return np.asarray(dq_k), np.asarray(dq_x), np.asarray(umax_k)


def _check(jcfg, tcfg, psi):
    dq_k, dq_x, umax_j = _jax_rhs(jcfg, psi)
    const = tqg.build_constants(tcfg, device="cpu")
    dq, umax = fused_rhs.rhs_fused_reference(tcfg, const, torch.as_tensor(psi))
    dq, umax = dq.numpy(), umax.numpy()
    assert dq.shape == psi.shape and umax.shape == (psi.shape[0],)
    for want in (dq_k, dq_x):
        np.testing.assert_allclose(dq, want, rtol=0,
                                   atol=1e-12 * max(np.abs(want).max(), 1.0))
    np.testing.assert_allclose(umax, umax_j, rtol=1e-13, atol=0)


def _psi(shape, seed):
    rng = np.random.default_rng(seed)
    psi = 1e-3 * rng.uniform(-1, 1, shape)
    return psi - psi.mean(axis=(-2, -1), keepdims=True)


@pytest.mark.parametrize("N,nl,Re", [(128, 3, 0), (64, 1, 0), (128, 4, 1000)])
def test_rhs_reference_matches_pallas_and_xla(N, nl, Re):
    jcfg, tcfg = _configs(N, nl, Re)
    psi = _psi((nl, N, N), N + nl)
    psi += 0.1 * np.random.default_rng(2).standard_normal(psi.shape)
    _check(jcfg, tcfg, psi)


def _ring(shape, seed):
    """Noise in the three cells next to each wall, zero inside: every
    output that feels a ghost is non-trivial, and the corners are hit."""
    psi = np.random.default_rng(seed).standard_normal(shape)
    psi[..., 3:-3, 3:-3] = 0.0
    return psi


@pytest.mark.parametrize("case", ["ring", "uniform", "corner"])
def test_rhs_reference_wall_hazards(case):
    """The places where a tiled kernel goes wrong, each held against the
    JAX kernel: (1) the ghosts of the derived fields zeta and tmp follow the
    Dirichlet rule on their own interior, not psi's ghosts; (2) corner
    ghosts compose x after y to +interior; (3) nothing beyond the first
    ghost ring feeds an output; (4) the wall faces enter umax through the
    ghosts (a uniform psi moves only there)."""
    N, nl = 64, 3
    jcfg, tcfg = _configs(N, nl, 1000.0)
    shape = (nl, N, N)
    if case == "ring":
        psi = _ring(shape, 7)
    elif case == "uniform":
        psi = np.ones(shape) * np.array([1.0, -2.0, 0.5])[:, None, None]
    else:
        psi = np.zeros(shape)
        psi[:, 0, 0] = psi[:, -1, -1] = 1.0
        psi[:, 0, -1] = psi[:, -1, 0] = -1.0
    _check(jcfg, tcfg, psi)


def test_rhs_f32_cancellation_within_kernel_limit():
    """Hazard (5): the biharmonic stacks three Laplacians on psi, so in f32
    the tendency carries cancellation error. At the bench's scaling
    (Re4 = 1563 (N/256)^3) the plain version in f32 stays within 1e-4 of
    max|dq| of the f64 result on the same f32-rounded psi: the limit
    chip_smoke.py holds the f32 kernel to."""
    N, nl = 128, 4
    kw = dict(Re4=1563 * (N / 256) ** 3, Eks=0.0, Fr=(0.003,) * (nl - 1))
    _, c64 = _configs(N, nl, 0.0, **kw)
    c32 = dataclasses.replace(c64, dtype="float32")
    psi = _psi((nl, N, N), 3).astype(np.float32)
    dq = {}
    for cfg in (c32, c64):
        const = tqg.build_constants(cfg, device="cpu")
        p = torch.as_tensor(psi).to(getattr(torch, cfg.dtype))
        dq[cfg.dtype] = fused_rhs.rhs_fused_reference(cfg, const, p)[0]
    ref = dq["float64"]
    err = (dq["float32"].double() - ref).abs().max() / ref.abs().max()
    assert err < 1e-4, float(err)


def test_rhs_fused_on_cpu_is_the_plain_version_and_counts_nothing():
    jcfg, tcfg = _configs(32, 2, 0.0)
    const = tqg.build_constants(tcfg, device="cpu")
    psi = torch.as_tensor(_psi((2, 32, 32), 1))
    before = fused_rhs.launches
    dq, umax = fused_rhs.rhs_fused(tcfg, const, psi)
    dq_r, umax_r = fused_rhs.rhs_fused_reference(tcfg, const, psi)
    assert fused_rhs.launches == before
    assert torch.equal(dq, dq_r) and torch.equal(umax, umax_r)


def test_rhs_fused_never_falls_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA card is refused;
    there is no silent route to the plain version."""
    _, tcfg = _configs(32, 2, 0.0)
    const = tqg.build_constants(tcfg, device="cpu")
    psi = torch.empty((2, 32, 32), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="device"):
        fused_rhs.rhs_fused(tcfg, const, psi)


def test_bound_work_at_the_main_path():
    """The compulsory traffic at 2048^2 x 4 f32: psi in and dq out, about
    134 MB (the y-profiles add a few kB)."""
    _, cfg = _configs(2048, 4, 0.0)
    const = types.SimpleNamespace(pp=None, zetap_pad=None, topo=None,
                                  iro=None, qforc=None)
    nbytes, nops = fused_rhs.bound_work(cfg, const, 4)
    assert 2 * 4 * 2048 ** 2 * 4 <= nbytes < 2 * 4 * 2048 ** 2 * 4 + 2 ** 16
    assert 100 * 4 * 2048 ** 2 < nops < 300 * 4 * 2048 ** 2
