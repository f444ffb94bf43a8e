"""The port's ops (msom_tpu_torch.ops, params) against the JAX package's on
identical float64 inputs, plus the port's isolation from JAX.

Stencils are held at atol 1e-13 x the output's scale: both sides evaluate
the same formula in the same order, so only the last bits may differ."""

import ast
import dataclasses
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msom_tpu import params as jparams
from msom_tpu.ops import bc as jbc
from msom_tpu.ops import ghost as jghost
from msom_tpu.ops import modes as jmodes
from msom_tpu.ops import stencil as jstencil
from msom_tpu.ops import stretch as jstretch
from msom_tpu_torch import params as tparams
from msom_tpu_torch.ops import bc as tbc
from msom_tpu_torch.ops import ghost as tghost
from msom_tpu_torch.ops import modes as tmodes
from msom_tpu_torch.ops import stencil as tstencil
from msom_tpu_torch.ops import stretch as tstretch
from tests import reference_numpy as ref

torch.set_num_threads(1)

BCS = ["dirichlet", "neumann", "periodic"]
SHAPES = [(1, 16, 16), (3, 24, 32)]


def _fields(shape, seed, n=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) for _ in range(n)]


def _close(got, want, scale_of=None):
    got = np.asarray(got)
    want = np.asarray(want)
    scale = np.abs(want if scale_of is None else scale_of).max()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-13 * max(scale, 1.0))


def _both(a, bc):
    """(JAX Ghosted, port Ghosted) of the same numpy field."""
    return (jghost.ghosted(jnp.asarray(a), jbc.BC(bc)),
            tghost.ghosted(torch.as_tensor(a), tbc.BC(bc)))


@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("shape", SHAPES)
def test_pad_matches_jax(bc, shape):
    (a,) = _fields(shape, 0, 1)
    got = tbc.pad(torch.as_tensor(a), tbc.BC(bc)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jbc.pad(jnp.asarray(a),
                                                          jbc.BC(bc))))
    np.testing.assert_array_equal(got[0], ref.pad_ref(a[0], bc))


def test_dirichlet_corner_ghost_is_plus_interior():
    """Corner ghosts compose x after y: two sign flips give +interior."""
    a = torch.arange(1.0, 17.0, dtype=torch.float64).reshape(4, 4)
    p = tbc.pad(a, tbc.BC.DIRICHLET)
    assert p[0, 0] == a[0, 0] and p[-1, -1] == a[-1, -1]
    assert p[0, -1] == a[0, -1] and p[-1, 0] == a[-1, 0]
    assert p[0, 1] == -a[0, 0] and p[1, 0] == -a[0, 0]


@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("shape", SHAPES)
def test_ghosted_ring_and_shifts_match_jax(bc, shape):
    (a,) = _fields(shape, 1, 1)
    jg, tg = _both(a, bc)
    np.testing.assert_array_equal(tg.p.numpy(), np.asarray(jg.padded()))
    np.testing.assert_array_equal(tg.a.numpy(), a)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            np.testing.assert_array_equal(tg.shift(dj, di).numpy(),
                                          np.asarray(jg.shift(dj, di)))


@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("shape", SHAPES)
def test_stencils_match_jax(bc, shape):
    p, q = _fields(shape, 2)
    d = 0.37
    jp, tp = _both(p, bc)
    jq, tq = _both(q, bc)
    _close(tghost.laplacian_g(tp, d), jghost.laplacian_g(jp, d))
    _close(tghost.arakawa_mjac_g(tp, tq, d), jghost.arakawa_mjac_g(jp, jq, d))
    _close(tghost.beta_effect_g(tp, 0.5, d), jghost.beta_effect_g(jp, 0.5, d))
    got = tghost.max_face_speed_layers(tp, d).numpy()
    want = np.asarray(jghost.max_face_speed_layers(jp, d))
    assert got.shape == (shape[0],)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)


@pytest.mark.parametrize("sbc", [0.0, 0.3, 2.0])
@pytest.mark.parametrize("shape", SHAPES)
def test_slip_ghosts_match_jax(sbc, shape):
    """pad_zeta_slip and ghosted_slip: the edge ghosts c (psi_in -
    psi_ghost), the corner ghosts left at the Dirichlet fill; sbc <= 0 is
    the plain Dirichlet pad."""
    psi, zeta = _fields(shape, 7)
    d = 0.37
    jpsi, tpsi = _both(psi, "dirichlet")
    want = np.asarray(jbc.pad_zeta_slip(jnp.asarray(zeta), jpsi.padded(),
                                        sbc, d))
    got = tbc.pad_zeta_slip(torch.as_tensor(zeta), tpsi.p, sbc, d).numpy()
    _close(got, want)
    jg = jghost.ghosted_slip(jnp.asarray(zeta), jpsi, sbc, d)
    tg = tghost.ghosted_slip(torch.as_tensor(zeta), tpsi, sbc, d)
    _close(tg.p, jg.padded())
    np.testing.assert_array_equal(tg.p.numpy(), got)
    dirichlet = tbc.pad(torch.as_tensor(zeta), tbc.BC.DIRICHLET).numpy()
    for cy, cx in ((0, 0), (0, -1), (-1, 0), (-1, -1)):
        np.testing.assert_array_equal(got[..., cy, cx],
                                      dirichlet[..., cy, cx])
    if sbc <= 0:
        np.testing.assert_array_equal(got, dirichlet)
    else:
        c = sbc / ((0.5 * sbc + 1.0) * d * d)
        _close(got[..., 1:-1, 0], 2 * c * psi[..., :, 0])


@pytest.mark.parametrize("bc", BCS)
def test_ghosted_from_padded_and_stencil_module_match_jax(bc):
    """ops/stencil.py on padded arrays against the JAX module, and a
    Ghosted built from a padded array against the JAX one."""
    p, q = _fields((3, 24, 32), 8)
    d = 0.37
    jpp, jqp = (jbc.pad(jnp.asarray(a), jbc.BC(bc)) for a in (p, q))
    tpp, tqp = (tbc.pad(torch.as_tensor(a), tbc.BC(bc)) for a in (p, q))
    jg, tg = jghost.ghosted_from_padded(jpp), tghost.ghosted_from_padded(tpp)
    np.testing.assert_array_equal(tg.p.numpy(), np.asarray(jg.padded()))
    for dj, di in ((-1, 1), (0, 0), (1, -1)):
        np.testing.assert_array_equal(tstencil.shift(tpp, dj, di).numpy(),
                                      np.asarray(jstencil.shift(jpp, dj, di)))
    _close(tstencil.laplacian(tpp, d), jstencil.laplacian(jpp, d))
    _close(tstencil.arakawa_mjac(tpp, tqp, d),
           jstencil.arakawa_mjac(jpp, jqp, d))
    _close(tstencil.beta_effect(tpp, 0.5, d),
           jstencil.beta_effect(jpp, 0.5, d))
    for got, want in zip(tstencil.face_velocities(tpp, d),
                         jstencil.face_velocities(jpp, d)):
        _close(got, want)
    # the face velocities carry the CFL maxima of max_face_speed_layers
    ufx, ufy = tstencil.face_velocities(tpp, d)
    np.testing.assert_allclose(
        torch.maximum(ufx.abs().amax(dim=(-2, -1)),
                      ufy.abs().amax(dim=(-2, -1))).numpy(),
        tghost.max_face_speed_layers(tg, d).numpy(), rtol=1e-13)


def test_stencils_match_loop_reference():
    """The port's Laplacian and Arakawa bracket against the per-cell loop
    transcriptions of the reference macros (tests/reference_numpy.py)."""
    p, q = _fields((16, 16), 3)
    d = 0.3
    tp = tghost.ghosted(torch.as_tensor(p), tbc.BC.DIRICHLET)
    tq = tghost.ghosted(torch.as_tensor(q), tbc.BC.DIRICHLET)
    pp, qp = ref.pad_ref(p, "dirichlet"), ref.pad_ref(q, "dirichlet")
    _close(tghost.laplacian_g(tp, d), ref.laplacian_ref(pp, d))
    _close(tghost.arakawa_mjac_g(tp, tq, d), ref.arakawa_ref(pp, qp, d))


def test_max_face_speed_reaches_wall_faces():
    """A uniform psi has no interior velocity: all of its face speed comes
    from the cells next to the walls, whose Dirichlet ghosts (-1) give
    |u| = (1 - (-1)) / (2 delta) = 1/delta."""
    N, d = 8, 0.5
    psi = torch.ones(2, N, N, dtype=torch.float64)
    got = tghost.max_face_speed_layers(
        tghost.ghosted(psi, tbc.BC.DIRICHLET), d)
    np.testing.assert_array_equal(got.numpy(), [1.0 / d, 1.0 / d])
    want = jghost.max_face_speed_layers(
        jghost.ghosted(jnp.asarray(psi.numpy()), jbc.BC.DIRICHLET), d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_arakawa_conservation_periodic():
    """sum J = 0, sum p J(p, q) = 0 (energy), sum q J(p, q) = 0
    (enstrophy) to roundoff on a periodic domain."""
    p, q = _fields((32, 32), 4)
    tp = tghost.ghosted(torch.as_tensor(p), tbc.BC.PERIODIC)
    tq = tghost.ghosted(torch.as_tensor(q), tbc.BC.PERIODIC)
    j = tghost.arakawa_mjac_g(tp, tq, 1.0).numpy()
    scale = np.abs(j).sum()
    assert abs(j.sum()) < 1e-13 * scale
    assert abs((p * j).sum()) < 1e-13 * scale
    assert abs((q * j).sum()) < 1e-13 * scale
    j2 = tghost.arakawa_mjac_g(tq, tp, 1.0).numpy()
    np.testing.assert_allclose(j, -j2, rtol=0, atol=1e-13 * np.abs(j).max())


@pytest.mark.parametrize("nl", [1, 2, 4])
def test_stretch_and_metrics_match_jax(nl):
    rng = np.random.default_rng(5)
    dh = rng.uniform(0.1, 1.0, nl)
    a = rng.standard_normal((nl, 12, 12))
    s = rng.uniform(0.5, 2.0, (max(nl - 1, 1), 12, 12))[:nl - 1]
    for got, want in zip(tstretch.layer_metrics(dh),
                         jstretch.layer_metrics(dh)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(tstretch.layer_metrics(dh)[1:],
                               ref.layer_metrics_ref(dh)[1:], rtol=1e-15)
    _, idh0, idh1 = tstretch.layer_metrics(dh)
    got = tstretch.stretch(torch.as_tensor(a), torch.as_tensor(s), idh0, idh1)
    want = jstretch.stretch(jnp.asarray(a), jnp.asarray(s), idh0, idh1)
    _close(got, want)
    if nl > 1:
        _close(got, ref.stretch_ref(a, s, idh0, idh1))


@pytest.mark.parametrize("nl", [2, 3, 4])
def test_modes_match_jax(nl):
    rng = np.random.default_rng(6)
    dh = rng.uniform(0.1, 1.0, nl)
    s = rng.uniform(1e3, 1e5, nl - 1)
    np.testing.assert_array_equal(tmodes.stretching_matrix(dh, s),
                                  jmodes.stretching_matrix(dh, s))
    got, want = tmodes.eigmod(dh, s), jmodes.eigmod(dh, s)
    for name in ("l2m", "m2l", "iBu", "Rd"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))


def test_config_parses_deck_like_jax():
    path = "msom_tpu/configs/double_gyre_small.in"
    got = tparams.load_qg_config(path, solver="spectral")
    want = jparams.load_qg_config(path, solver="spectral")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for name in ("iRe", "iRe4", "delta", "itr_stoch", "iPe", "ptr_ir"):
        assert getattr(got, name) == getattr(want, name)
    assert got.dt_clamped() == want.dt_clamped()
    with pytest.raises(ValueError, match="Rom"):
        tparams.QGConfig(N=8).validate()


_ISOLATION = """
import importlib, pkgutil, sys
import msom_tpu_torch
names = ["msom_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    msom_tpu_torch.__path__, "msom_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert {"msom_tpu_torch.parallel." + m for m in
        ("dist", "halo", "spectral_shard", "step")} <= set(names), names
assert {"msom_tpu_torch.api", "msom_tpu_torch.native"} <= set(names), names
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "msom_tpu."))
             or m == "msom_tpu")
assert not bad, bad
print(len(names))
"""


def test_port_imports_no_jax_and_no_reference_package():
    """Importing the port and every module in it, the distributed step's
    `parallel/`, the tendency API and the native bindings among them,
    leaves jax and msom_tpu out of sys.modules."""
    out = subprocess.run([sys.executable, "-c", _ISOLATION],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 17


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


_ROOT = Path(__file__).resolve().parent.parent
_PORT_FILES = sorted(str(p.relative_to(_ROOT)) for p in
                     (_ROOT / "msom_tpu_torch").rglob("*.py")) \
    + ["chip_smoke.py"]


@pytest.mark.parametrize("path", _PORT_FILES)
def test_port_source_names_no_jax_import(path):
    """Every import statement of the port and of chip_smoke.py, the lazy
    ones inside functions included, stays clear of jax and msom_tpu."""
    for mod in _imported_modules(_ROOT / path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "msom_tpu"), (path, mod)


def test_chip_smoke_fails_without_a_card():
    """With no CUDA card chip_smoke.py exits non-zero and prints no result
    line."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, str(_ROOT / "chip_smoke.py")],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_entry_points_default_to_cuda(monkeypatch):
    from msom_tpu_torch import convert, coupling, driver, driver_node
    from msom_tpu_torch.models import mspg, qg, qg_energy, qg_node
    from msom_tpu_torch.ops import vertex
    from msom_tpu_torch.solvers import mg, spectral, vmg
    for fn in (qg.build_constants, spectral.build_spectral,
               convert.state_from_numpy, qg_node.build_constants,
               spectral.build_spectral_node, convert.node_state_from_numpy,
               mg.build_layered_coeffs, vmg.build_vlevels,
               vertex.default_mask, driver.run_qg, qg_energy.init_energy,
               qg_node.build_constants_periodic, driver_node.run_node,
               mspg.build_constants, driver.run_pg,
               convert.pg_state_from_numpy, coupling.pg_to_qg_inputs):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    # the node command line hands run_node the card unless --cpu is given
    seen = []
    monkeypatch.setattr(driver_node, "run_node",
                        lambda cfg, **kw: seen.append(kw["device"]))
    cfg = _ROOT / "msom_tpu" / "configs" / "double_gyre_small.in"
    for extra in ([], ["--cpu"]):
        driver_node.main(["--config", str(cfg)] + extra)
    assert seen == ["cuda", "cpu"]
