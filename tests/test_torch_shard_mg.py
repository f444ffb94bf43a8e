"""The sharded multigrid of the port (msom_tpu_torch.parallel.shard_mg) and
the 2-D halo exchanges it runs on, on CPU ranks in a gloo group
(torch.multiprocessing.spawn, a file:// store under tmp_path), at world
sizes 2 and 4: each world size is one spawn whose ranks run every part
(tests/torch_mesh_ranks.py), torch and the port only; the JAX references
are computed here, once for the module, the JAX package's sharded
functions under shard_map on its 8-device CPU mesh.

* ghosted_sharded (Dirichlet, Neumann, periodic) and ghosted_slip_sharded
  (sbc 0 and 5) of every rank at meshes (2, 1), (1, 2), (4, 1) and (2, 2),
  bit for bit the tile's window of JAX's global ghosted / ghosted_slip;
* JAX's own shard_map ghosted_slip_sharded on a 2 x 2 mesh, which parts
  from the whole field's law at the ring corners on the walls (a fault of
  the JAX package that the port does not share);
* solve_layered_sharded at meshes (2, 1), (4, 1) and (2, 2), 32^2 x 3 f64
  at tol 1e-8 (levels 32 ... 2: on 4 rows the levels below 8 are whole on
  every rank, the replicated tail), within 1e-12 of max|a| of JAX's
  unsharded mg.solve_layered, with the iteration count of JAX's
  solve_layered_sharded on the same mesh;
* the rows step with solver="mg" at worlds 2 and 4, uncoupled and coupled
  (psipg, topography, qforc, 2 tracers), 3 steps against JAX's unsharded
  make_step: q, psi and the tracers within 1e-12 of their maxima, dt and
  KE at rtol 1e-12, the V-cycles of every step equal.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from msom_tpu.models import qg as jqg
from msom_tpu.ops.bc import BC as JBC
from msom_tpu.ops.ghost import ghosted as jghosted
from msom_tpu.ops.ghost import ghosted_slip as jghosted_slip
from msom_tpu.params import QGConfig as JConfig
from msom_tpu.parallel import shard_mg as jshard_mg
from msom_tpu.parallel.step import tree_specs
from msom_tpu.solvers import mg as jmg

import torch_mesh_ranks

torch.set_num_threads(1)

N, NL, STEPS = 64, 3, 3
BASE = dict(N=N, nl=NL, L0=80, Rom=0.025, Ekb=0.002, Eks=1e-3, tau0=1e-4,
            Re=500.0, Re4=1563, beta=0.5, Fr=(0.0023669, 0.0076173),
            dh=(0.06, 0.14, 0.8), DT=5e-2, tend=1.0, dtout=1.0, CFL=0.6,
            sbc=2.0, solver="mg", dtype="float64")
COUPLED = dict(flsrv=1, nptr=2, Pe=(1e3, 2e3), ptr_r=(100.0, 0.0))
MG_KW = dict(BASE, N=32)
MG_TOL = 1e-8
MESHES = {2: [(2, 1), (1, 2)], 4: [(4, 1), (2, 2)]}
MG_MESHES = {2: [(2, 1)], 4: [(4, 1), (2, 2)]}


def inputs(coupled, seed=0, n=N, nptr=2):
    """(fields, psi0, tr0): psipg, topography and qforc when coupled."""
    rng = np.random.default_rng(seed)
    y = (np.arange(n) + 0.5) * 80.0 / n
    fields = {}
    if coupled:
        fields = dict(psipg=1e-3 * rng.uniform(-1, 1, (NL, n, n)),
                      topo=0.05 * np.outer(np.sin(np.pi * y / 80),
                                           np.sin(2 * np.pi * y / 80)),
                      qforc=1e-5 * rng.standard_normal((NL, n, n)))
    psi0 = 1e-3 * rng.uniform(-1, 1, (NL, n, n))
    tr0 = 1e-3 * rng.uniform(-1, 1, (NL, nptr, n, n)) if coupled else None
    return fields, psi0 - psi0.mean(axis=(-2, -1), keepdims=True), tr0


CASES = {"uncoupled": BASE, "coupled": dict(BASE, **COUPLED)}


def _job(world):
    return {"halo": MESHES[world],
            "mg": {s: (s, MG_KW, MG_TOL) for s in MG_MESHES[world]},
            "steps": {name: (kw, *inputs(name == "coupled"), STEPS, "rows",
                             None)
                      for name, kw in CASES.items()}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: rank 0's results} for worlds 2 and 4."""
    tmp = tmp_path_factory.mktemp("shard_mg")
    return {w: torch_mesh_ranks.run(w, _job(w), tmp) for w in (2, 4)}


def jax_mesh(shape):
    my, mx = shape
    return Mesh(np.array(jax.devices()[:my * mx]).reshape(my, mx),
                ("y", "x"))


def _rel(got, want):
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("world", [2, 4])
def test_ghosted_sharded_is_the_whole_fields_pad(ranks, world):
    """Every rank's ghost ring, each law, bit for bit the window of JAX's
    ghosted of the whole field (the slip law's from JAX's ghosted_slip,
    sbc 0 and 5, with the rank's ghosted psi)."""
    a, z, p = (jnp.asarray(x.numpy()) for x in
               torch_mesh_ranks.halo_fields(32))
    want = {bc.value: np.asarray(jghosted(a, bc).padded())
            for bc in (JBC.DIRICHLET, JBC.NEUMANN, JBC.PERIODIC)}
    for sbc in (0.0, 5.0):
        want[f"slip{sbc:g}"] = np.asarray(jghosted_slip(
            z, jghosted(p, JBC.DIRICHLET), sbc, 0.25).padded())
    for shape, res in ranks[world]["halo"].items():
        my, mx = shape
        ny, nx = 32 // my, 32 // mx
        for law, tiles in res.items():
            for rank, tile in enumerate(tiles):
                yi, xi = divmod(rank, mx)
                w = want[law][:, yi * ny:yi * ny + ny + 2,
                              xi * nx:xi * nx + nx + 2]
                assert np.array_equal(tile.numpy(), w), (shape, law, rank)


def test_jax_sharded_slip_ring_differs_from_the_whole_fields(ranks):
    """A fault of the JAX package's shard_map form of ghosted_slip
    (halo.py:86-107), which the port does not share: on a 2 x 2 mesh with
    sbc = 5 its ring corners that lie on a wall, away from the grid's
    corners, keep the Dirichlet fill where the whole field's law
    (ghosted_slip, what JAX's GSPMD run computes) puts the slip value;
    everywhere else the rings agree. The port's rings are the whole
    field's bit for bit (test_ghosted_sharded_is_the_whole_fields_pad)."""
    from msom_tpu.parallel import halo as jhalo
    _, z, p = (jnp.asarray(x.numpy()) for x in
               torch_mesh_ranks.halo_fields(32))
    want = np.asarray(jghosted_slip(z, jghosted(p, JBC.DIRICHLET), 5.0,
                                    0.25).padded())

    def local(z, p):
        pg = jhalo.ghosted_sharded(p, JBC.DIRICHLET)
        return jhalo.ghosted_slip_sharded(z, pg, 5.0, 0.25).padded()

    f = jax.jit(shard_map(local, mesh=jax_mesh((2, 2)),
                          in_specs=(P(None, "y", "x"),) * 2,
                          out_specs=P(None, "y", "x"), check_vma=False))
    rings = np.asarray(f(z, p))            # the four 18 x 18 rings, tiled
    port = ranks[4]["halo"][(2, 2)]["slip5"]
    bad = set()
    for rank in range(4):
        yi, xi = divmod(rank, 2)
        w = want[:, yi * 16:yi * 16 + 18, xi * 16:xi * 16 + 18]
        got = rings[:, yi * 18:(yi + 1) * 18, xi * 18:(xi + 1) * 18]
        assert np.array_equal(port[rank].numpy(), w)
        bad |= {(rank, j, i) for _, j, i in np.argwhere(got != w)}
    # per rank, the one ring corner on a wall between two tiles, each way
    assert bad == {(0, 0, 17), (0, 17, 0), (1, 0, 0), (1, 17, 17),
                   (2, 0, 0), (2, 17, 17), (3, 0, 17), (3, 17, 0)}


@functools.cache
def jax_mg_problem():
    """(cfg, const, a0, b, JAX's unsharded solution and iteration count) of
    the multigrid units' problem."""
    _, b, _, _ = torch_mesh_ranks.mg_problem(MG_KW)
    cfg = JConfig(**MG_KW).validate()
    const = jqg.build_constants(cfg)
    b = jnp.asarray(b.numpy())
    a0 = jnp.zeros_like(b)
    a_ref, st = jmg.solve_layered(a0, b, L0=cfg.L0, s=const.strl,
                                  idh0=const.idh0, idh1=const.idh1,
                                  bc=JBC.DIRICHLET, tolerance=MG_TOL,
                                  levels=const.levels)
    return cfg, const, a0, b, np.asarray(a_ref), int(st.iters)


def jax_sharded_iters(shape):
    """The iteration count of JAX's solve_layered_sharded on `shape`."""
    cfg, const, a0, b, _, _ = jax_mg_problem()
    my, mx = shape
    f = jax.jit(shard_map(
        lambda a, bb, lv: jshard_mg.solve_layered_sharded(
            a, bb, levels=lv, my=my, mx=mx, idh0=const.idh0,
            idh1=const.idh1, bc=JBC.DIRICHLET, tolerance=MG_TOL)[1].iters,
        mesh=jax_mesh(shape),
        in_specs=(P(None, "y", "x"), P(None, "y", "x"),
                  tree_specs(const.levels, my, mx)),
        out_specs=P(), check_vma=False))
    return int(f(a0, b, const.levels))


@pytest.mark.parametrize("world,shape", [(2, (2, 1)), (4, (4, 1)),
                                         (4, (2, 2))])
def test_solve_layered_sharded_matches_jax(ranks, world, shape):
    """The sharded solve, gathered, within 1e-12 of JAX's unsharded
    solve, in JAX's sharded iteration count (which is its unsharded one)."""
    a, st = ranks[world]["mg"][shape]
    *_, want, iters = jax_mg_problem()
    assert st.resa < MG_TOL
    assert st.iters == jax_sharded_iters(shape) == iters
    assert _rel(a, want) < 1e-12


@functools.cache
def jax_steps(name):
    """JAX's unsharded make_step, STEPS steps: (q, psi, tr, [(dt, ke,
    cycles)])."""
    kw = CASES[name]
    fields, psi0, tr0 = inputs(name == "coupled")
    cfg = JConfig(**kw).validate()
    const = jqg.build_constants(cfg, **fields)
    s = jqg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
    step = jax.jit(jqg.make_step(cfg))
    diags = []
    for _ in range(STEPS):
        s, d = step(s, const, jnp.asarray(1e9))
        diags.append((float(d.dt), float(d.ke), int(d.mg_iters)))
    tr = None if s.tracers is None else np.asarray(s.tracers)
    return np.asarray(s.q), np.asarray(s.psi), tr, diags


def check_step(got, want):
    """q, psi (and tracers) within 1e-12 of their maxima, dt and KE at
    rtol 1e-12, the V-cycles of every step equal."""
    q, psi, tr, diags = got[:4]
    wq, wpsi, wtr, wdiags = want
    assert _rel(q, wq) < 1e-12
    assert _rel(psi, wpsi) < 1e-12
    if wtr is not None:
        assert _rel(tr, wtr) < 1e-12
    for (dt, ke, it), (wdt, wke, wit) in zip(diags, wdiags, strict=True):
        assert abs(dt - wdt) <= 1e-12 * wdt
        assert abs(ke - wke) <= 1e-12 * abs(wke)
        assert it == wit


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_rows_mg_step_matches_jax(ranks, case, world):
    """The rows step with the sharded multigrid on `world` ranks against
    JAX's unsharded mg step."""
    got = ranks[world]["steps"][case]
    assert got[4] == "rows" and got[5] == (world, 1)
    check_step(got, jax_steps(case))
