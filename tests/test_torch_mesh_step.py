"""The general-mesh step of the port (msom_tpu_torch.parallel.step's
"gspmd" mode: the port's explicit form of the JAX package's GSPMD run),
its 2-D spectral solves, and run_qg's routing, on CPU ranks in a gloo
group (torch.multiprocessing.spawn, a file:// store under tmp_path), at
world sizes 2 and 4: each world size is one spawn whose ranks run every
part (tests/torch_mesh_ranks.py), torch and the port only; the JAX
references are computed here, once for the module.

* transform_sharded (forward and inverse) and solve_spectral_sharded,
  walled and periodic, 32^2 x 3 f64 on the meshes (1, 2) and (2, 2),
  within 1e-13 of max|out| of JAX's, run under shard_map on its 8-device
  CPU mesh;
* the general-mesh step, coupled (psipg, topography, qforc, 2 tracers,
  partial slip), 3 steps from the same state against JAX's unsharded
  make_step: spectral and mg at (2, 2), the modal inversion
  (mode_pv_invert) at (2, 2), varRo with the spectral solver (the
  y-profile solve: an all_to_all in each mesh column, the block-Thomas
  sweeps on whole columns) at (2, 2) and (4, 1); q, psi and the tracers
  within 1e-12 of their maxima, dt and KE at rtol 1e-12, the V-cycles of
  every step equal;
* run_qg(sharded="auto") at world 2 returns the mode JAX's run_qg records
  (run_qg.sharded_mode, on a 2-device mesh): "rows" for solver="mg",
  "gspmd" for varRo, mode_pv_invert and N = 32 (the JAX kernels' tile
  gate), with JAX's states after 3 steps; N = 20 (no JAX constants: the
  JAX package's wavelet pyramid needs a power of 2) runs "gspmd" on a
  (1, 2) mesh and matches the port's unsharded run; sharded="rows" on
  varRo raises ValueError, as JAX's run_qg does.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from msom_tpu import driver as jdriver
from msom_tpu.models import qg as jqg
from msom_tpu.params import QGConfig as JConfig
from msom_tpu.parallel import spectral_shard as jss
from msom_tpu.solvers import spectral as jspectral
from msom_tpu_torch.models import qg as tqg
from msom_tpu_torch.params import QGConfig as TConfig

import torch_mesh_ranks
from test_torch_shard_mg import BASE, COUPLED, check_step, inputs

torch.set_num_threads(1)

STEPS = 3
KW = dict(BASE, **COUPLED)
CASES = {"spectral": dict(KW, solver="spectral"), "mg": KW,
         "modal": dict(KW, mode_pv_invert=True),
         "varro": dict(KW, solver="spectral", varRo=1)}
STEP_RUNS = {"spectral": ("spectral", (2, 2)), "mg": ("mg", (2, 2)),
             "modal": ("modal", (2, 2)), "varro22": ("varro", (2, 2)),
             "varro41": ("varro", (4, 1))}
SPECTRAL_MESHES = {2: (1, 2), 4: (2, 2)}
# the bf16 + refinement solve's meshes (f64 on the CPU: full-precision
# passes), at 1e-12 of JAX's
REFINE_MESHES = {2: (2, 1), 4: (2, 2)}
# the routing runs at world 2: {name: (config, JAX's reference case)},
# with no event before the steps end (so that dtnext leaves dt as the
# steps' own)
FAR = dict(tend=1e9, dtout=1e9)
ROUTES = {"mg": (dict(CASES["mg"], **FAR), "mg"),
          "varro": (dict(CASES["varro"], **FAR), "varro"),
          "modal": (dict(CASES["modal"], **FAR), "modal"),
          "n32": (dict(CASES["spectral"], N=32, **FAR), None),
          "n20": (dict(CASES["spectral"], N=20, **FAR), None)}


def _inputs(kw):
    return inputs(True, n=kw["N"])


def _job(world):
    job = {"spectral": {
        (p, refine): ((REFINE_MESHES if refine else SPECTRAL_MESHES)[world],
                      32, 3, p, refine)
        for p in (False, True) for refine in (False, True)}}
    if world == 4:
        job["steps"] = {name: (CASES[case], *_inputs(CASES[case]), STEPS,
                               "gspmd", mesh)
                        for name, (case, mesh) in STEP_RUNS.items()}
    else:
        job["driver"] = {name: (kw, *_inputs(kw), STEPS, "auto")
                         for name, (kw, _) in ROUTES.items()}
        job["driver"]["varro_rows"] = (CASES["varro"],
                                       *_inputs(CASES["varro"]), 1, "rows")
    return job


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: rank 0's results} for worlds 2 and 4."""
    tmp = tmp_path_factory.mktemp("mesh_step")
    return {w: torch_mesh_ranks.run(w, _job(w), tmp) for w in (2, 4)}


def jax_mesh(shape):
    my, mx = shape
    return Mesh(np.array(jax.devices()[:my * mx]).reshape(my, mx),
                ("y", "x"))


def _rel(got, want):
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("periodic", [False, True])
def test_spectral_sharded_matches_jax(ranks, world, periodic, refine):
    """transform_sharded both ways and solve_spectral_sharded on the mesh,
    gathered, against JAX's under shard_map on the same mesh; with refine
    the bf16 + refinement solve (its residual's ghosts from the halo
    exchange) on the (2, 1) and (2, 2) meshes, within 1e-12."""
    shape = (REFINE_MESHES if refine else SPECTRAL_MESHES)[world]
    my, mx = shape
    _, q = torch_mesh_ranks.spectral_problem(32, 3, periodic)
    sd = jspectral.build_spectral(
        nl=3, N=32, L0=80.0, dh=np.array([0.06, 0.14, 0.8]),
        s_profile=np.array([8.96, 0.97]), periodic=periodic,
        dtype=jnp.float64, force_matmul=True, refine=refine)

    def local(d, a):
        prec = jax.lax.Precision.HIGHEST
        return (jss.transform_sharded(a, d.S, inverse=False, precision=prec),
                jss.transform_sharded(a, d.S, inverse=True, precision=prec),
                jss.solve_spectral_sharded(d, a))

    f = jax.jit(shard_map(local, mesh=jax_mesh(shape),
                          in_specs=(jss.specs(sd, my, mx), P(None, "y", "x")),
                          out_specs=(P(None, "y", "x"),) * 3,
                          check_vma=False))
    want = f(sd, jnp.asarray(q.numpy()))
    got = ranks[world]["spectral"][periodic, refine]
    for name, g, w in zip(("forward", "inverse", "solve"), got, want):
        tol = 1e-12 if refine and name == "solve" else 1e-13
        assert _rel(g, np.asarray(w)) < tol, name


def test_pencil_solve_refuses_refine():
    """The pencil solve refuses refine data with ValueError, as JAX's
    asserts (spectral_shard.py:148); so the rows step does not take refine
    constants and sharded="auto" sends them to the mesh solve."""
    from msom_tpu_torch.parallel import spectral_shard as tss
    from msom_tpu_torch.parallel import step as tstep
    sd, q = torch_mesh_ranks.spectral_problem(32, 3, False, refine=True)
    with pytest.raises(ValueError, match="refine"):
        tss.pencil_data(sd, 0, 2)
    jd = jspectral.build_spectral(
        nl=3, N=32, L0=80.0, dh=np.array([0.06, 0.14, 0.8]),
        s_profile=np.array([8.96, 0.97]), periodic=False,
        dtype=jnp.float64, force_matmul=True, refine=True)
    with pytest.raises(AssertionError, match="refine"):
        jss.solve_spectral_pencil(jd, jnp.asarray(q.numpy()))
    cfg = TConfig(**CASES["spectral"]).validate()
    const = tqg.build_constants(cfg, device="cpu")
    assert tstep.route(cfg, 2, const) == "rows"
    const = dataclasses.replace(const, spec=sd)
    assert "refine" in tstep.rows_refusal(cfg, 2, const)
    assert tstep.route(cfg, 2, const) == "gspmd"


@functools.cache
def jax_steps(case):
    """JAX's unsharded make_step, STEPS steps: (q, psi, tr, [(dt, ke,
    cycles)])."""
    kw = CASES[case]
    fields, psi0, tr0 = _inputs(kw)
    cfg = JConfig(**kw).validate()
    const = jqg.build_constants(cfg, **fields)
    s = jqg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
    step = jax.jit(jqg.make_step(cfg))
    diags = []
    for _ in range(STEPS):
        s, d = step(s, const, jnp.asarray(1e9))
        diags.append((float(d.dt), float(d.ke), int(d.mg_iters)))
    return np.asarray(s.q), np.asarray(s.psi), np.asarray(s.tracers), diags


@pytest.mark.parametrize("name", list(STEP_RUNS))
def test_mesh_step_matches_jax(ranks, name):
    """The general-mesh step on 4 ranks against JAX's unsharded step."""
    case, mesh = STEP_RUNS[name]
    got = ranks[4]["steps"][name]
    assert got[4] == "gspmd" and got[5] == mesh
    check_step(got, jax_steps(case))


def jax_mode(kw, world=2):
    """The mode JAX's run_qg(sharded="auto") records on a `world`-device
    rows mesh (no step is taken: tend = 0)."""
    cfg = JConfig(**dict(kw, tend=0.0)).validate()
    jdriver.run_qg(cfg, sharded="auto", mesh=jax_mesh((world, 1)))
    return jdriver.run_qg.sharded_mode


@pytest.mark.parametrize("name", list(ROUTES))
def test_run_qg_routes_as_jax(ranks, name):
    """run_qg(sharded="auto") at world 2: JAX's mode, and JAX's state
    after the steps (or, at N = 20, the port's unsharded run's)."""
    kw, case = ROUTES[name]
    q, psi, mode = ranks[2]["driver"][name]
    want_mode = "gspmd" if name == "n20" else jax_mode(kw)
    assert mode == want_mode == ("rows" if name == "mg" else "gspmd")
    if case is not None:
        wq, wpsi, _, _ = jax_steps(case)
    else:
        fields, psi0, tr0 = _inputs(kw)
        cfg = TConfig(**kw).validate()
        const = tqg.build_constants(cfg, device="cpu", **fields)
        state = tqg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
        step = tqg.make_step(cfg)
        for _ in range(STEPS):
            state, _ = step(state, const, 1e9)
        wq, wpsi = state.q.numpy(), state.psi.numpy()
    assert _rel(q, wq) < 1e-12
    assert _rel(psi, wpsi) < 1e-12


def test_run_qg_rows_refuses_what_jax_refuses(ranks):
    """sharded="rows" on varRo with the spectral solver raises ValueError,
    from the port's run_qg and from JAX's."""
    got = ranks[2]["driver"]["varro_rows"]
    assert got[:2] == ("raises", "ValueError")
    assert "rows" in got[2]
    cfg = JConfig(**dict(CASES["varro"], tend=0.0)).validate()
    with pytest.raises(ValueError, match="rows"):
        jdriver.run_qg(cfg, sharded="rows", mesh=jax_mesh((2, 1)))
