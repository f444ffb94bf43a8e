"""The halo/compute overlap of the port's sharded steps (JAX's
MSOM_HALO_OVERLAP forms, msom_tpu/parallel/halo.py:123-180):
halo.ghosted_issue, whose pending ring completes to ghosted_sharded's, and
the overlapped stencils neighbor_sum_overlap(_g) and
laplacian_overlap(_g), which the general-mesh step's zeta and the sharded
multigrid's colours and residuals take. They split the interior from the
rim where a transfer is in flight and the tile holds at least
halo.SPLIT_MIN_BYTES, and sum the whole ring after the wait otherwise;
these tiles are below that threshold, so the split is run by setting it to
0 ("split") and the shipped rule by leaving it ("whole").

* in process, float64: the overlapped stencils bit for bit the plain ones
  on seeded tiles (Dirichlet, Neumann, periodic; tiles with and without
  an interior; rings from the (1, 1) mesh and arbitrary rings), the
  overlapped colour and residual forms of fused_mg bit for bit the plain
  ones, and JAX's own overlapped forms on the same Ghosted within 1e-15
  of the maximum; the bulk's three adds are enqueued before the pending
  ring's wait, from a tile of SPLIT_MIN_BYTES up, and after it below (a
  spy on the works and on torch's adds);
* on CPU ranks in a gloo group (torch.multiprocessing.spawn, a file://
  store; tests/torch_mesh_ranks.py's "overlap" part), worlds 2 and 4, one
  spawn each: every rank's issued ring is ghosted_sharded's and the
  overlapped stencils the plain ones, bit for bit, on the meshes (2, 2)
  and (4, 1), and (2, 1) and (1, 2) on the first two of the four ranks,
  split and whole; split, every exchange of the general-mesh step's zeta
  and of the sharded multigrid's colours and residual is posted before
  the bulk's adds and waited on after them, and whole it is waited on
  before them;
* the general-mesh step (spectral and mg, coupled: psipg, topography,
  qforc, 2 tracers, partial slip; 32^2 x 3, 2 steps) and
  solve_layered_sharded (32^2 x 3, tol 1e-8), split and whole, on the
  meshes (1, 1) (in process, no group), (2, 1), (1, 2), (2, 2) and
  (4, 1): the same bits, and within 1e-12 of JAX's unsharded make_step
  and mg.solve_layered (tests/test_torch_shard_mg.py's check_step).
"""

import functools

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import jax
import jax.numpy as jnp

from msom_tpu.models import qg as jqg
from msom_tpu.ops.bc import BC as JBC
from msom_tpu.ops.ghost import ghosted as jghosted
from msom_tpu.params import QGConfig as JConfig
from msom_tpu.parallel import halo as jhalo
from msom_tpu_torch.models import qg as tqg
from msom_tpu_torch.ops.bc import BC
from msom_tpu_torch.ops.ghost import Ghosted, laplacian_g, neighbor_sum
from msom_tpu_torch.parallel import halo, shard_mg
from msom_tpu_torch.parallel.mesh import make_mesh
from msom_tpu_torch.parallel.step import make_qg_step_sharded
from msom_tpu_torch.params import QGConfig as TConfig
from msom_tpu_torch.solvers import fused_mg

import torch_mesh_ranks
from test_torch_shard_mg import (BASE, COUPLED, MG_KW, MG_TOL, check_step,
                                 inputs, jax_mg_problem, _rel)

torch.set_num_threads(1)

N, STEPS = 32, 2
KW = dict(BASE, **COUPLED, N=N)
STEP_CASES = {"spectral": dict(KW, solver="spectral"), "mg": KW}
MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2), (4, 1)]}
RINGS = [(2, 2), (4, 1), (2, 1), (1, 2)]
LAWS = (BC.DIRICHLET, BC.NEUMANN, BC.PERIODIC)
TILES = [(3, 8, 8), (2, 5, 7), (3, 3, 3), (1, 2, 4)]


def _job(world):
    job = {"steps": {(name, mesh): (kw, *inputs(True, n=N), STEPS, mesh)
                     for name, kw in STEP_CASES.items()
                     for mesh in MESHES[world]},
           "mg": {mesh: (MG_KW, MG_TOL) for mesh in MESHES[world]}}
    if world == 4:
        job.update(rings=RINGS, spy=(2, 2))
    return {"overlap": job}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: rank 0's "overlap" results} for worlds 2 and 4."""
    tmp = tmp_path_factory.mktemp("overlap")
    return {w: torch_mesh_ranks.run(w, _job(w), tmp)["overlap"]
            for w in (2, 4)}


def _tile(shape, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape))


@pytest.mark.parametrize("bc", LAWS, ids=[b.value for b in LAWS])
def test_overlapped_stencils_are_the_plain_ones(bc, monkeypatch):
    """On the (1, 1) mesh (no group) and on arbitrary rings: the issued
    ring is ghosted_sharded's, neighbor_sum_overlap(_g) and
    laplacian_overlap(_g) are neighbor_sum and laplacian_g, and
    fused_mg's relax_color_sum and residual_lap are relax_color and
    residual_plain, bit for bit (an arbitrary ring held in flight and
    SPLIT_MIN_BYTES 0, so that the interior/rim split runs; the (1, 1)
    mesh's ring is complete at once and summed whole); JAX's
    neighbor_sum_overlap_g and laplacian_overlap_g on the same Ghosted
    (tiles of 3 x 3 or more: JAX's rim takes two columns) within 1e-15 of
    the maximum."""
    monkeypatch.setattr(halo, "SPLIT_MIN_BYTES", 0)
    mesh = make_mesh()
    for shape in TILES:
        a = _tile(shape)
        g = halo.ghosted_sharded(a, bc, mesh)
        pending = halo.ghosted_issue(a, bc, mesh)
        assert torch.equal(pending.wait().p, g.p)
        assert torch.equal(halo.neighbor_sum_overlap_g(pending),
                           neighbor_sum(g))
        assert torch.equal(halo.neighbor_sum_overlap(a, bc, mesh),
                           neighbor_sum(g))
        assert torch.equal(halo.laplacian_overlap(a, bc, 0.3, mesh),
                           laplacian_g(g, 0.3))
        # a ring that is no law of the tile's, still in flight (the
        # interior/rim split runs): every rim cell reads it
        r = Ghosted(_tile((*shape[:-2], shape[-2] + 2, shape[-1] + 2), 1))

        def flying():
            return halo.PendingGhosted(r.a, [], lambda: r)

        assert not flying().done and halo.PendingGhosted.ready(r).done
        assert torch.equal(halo.neighbor_sum_overlap_g(flying()),
                           neighbor_sum(r))
        assert torch.equal(halo.laplacian_overlap_g(flying(), 0.7),
                           laplacian_g(r, 0.7))
        res, t0, cp, im = (_tile(shape, s) for s in (2, 3, 4, 5))
        mask = fused_mg.checkerboard(shape[-2], shape[-1], "cpu")
        assert torch.equal(
            fused_mg.relax_color_sum(neighbor_sum(r), r.a, -0.09 * res, t0,
                                     cp, im, mask),
            fused_mg.relax_color(r, res, t0, cp, im, mask, 0.09))
        s, lam = _tile((shape[0] - 1, 1, 1), 6), _tile((shape[0], 1, 1), 7)
        idh = list(np.linspace(1.0, 2.0, shape[0]))
        for sl in ((None, None), (s if shape[0] > 1 else None, lam)):
            want = fused_mg.residual_plain(r, res, *sl, 0.7, idh, idh)
            got = fused_mg.residual_lap(
                halo.laplacian_overlap_g(flying(), 0.7), r.a, res, *sl, idh,
                idh)
            assert all(torch.equal(x, y) for x, y in zip(got, want))
        # JAX's own overlapped forms on the same Ghosted (its ghosted of
        # the tile)
        jg = jghosted(jnp.asarray(a.numpy()), JBC(bc.value))
        jr = Ghosted(torch.tensor(np.asarray(jg.padded())))
        if min(shape[-2:]) >= 3:
            assert _rel(halo.neighbor_sum_overlap_g(halo.PendingGhosted(
                jr.a, [], lambda: jr)), np.asarray(
                jhalo.neighbor_sum_overlap_g(jg))) <= 1e-15, shape
            assert _rel(halo.laplacian_overlap_g(halo.PendingGhosted(
                jr.a, [], lambda: jr), 0.3), np.asarray(
                jhalo.laplacian_overlap_g(jg, 0.3))) <= 1e-15, shape


def test_bulk_is_enqueued_before_the_wait(monkeypatch):
    """neighbor_sum_overlap_g on a ring still in flight: from a tile of
    SPLIT_MIN_BYTES up, its interior's three adds come before the
    transfers' wait, the rim's six after it; on a smaller tile the wait
    comes first and the whole ring is summed in three adds. The shipped
    threshold lies between one rank's 2048^2 x 4 f32 tile and two ranks'
    (halo.py)."""
    log = []

    class Adds(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "") in ("add", "add_"):
                log.append(func.__name__)
            return func(*args, **(kwargs or {}))

    class Work:
        def wait(self):
            log.append("wait")

    a = _tile((3, 8, 8))
    g = halo.ghosted_sharded(a, BC.DIRICHLET, make_mesh())
    nbytes = a.numel() * a.element_size()
    split = ["add", "add_", "add_", "wait"] + ["add", "add_", "add_"] * 2
    whole = ["wait", "add", "add", "add"]
    for limit, want in ((nbytes, split), (nbytes + 1, whole),
                        (halo.SPLIT_MIN_BYTES, whole)):
        monkeypatch.setattr(halo, "SPLIT_MIN_BYTES", limit)
        log.clear()
        pending = halo.PendingGhosted(a, [Work()], lambda: g)
        with Adds():
            got = halo.neighbor_sum_overlap_g(pending)
        assert log == want, limit
        assert torch.equal(got, neighbor_sum(g))
        assert pending.wait() is g and log.count("wait") == 1
    assert 1024 * 2048 * 4 * 4 < halo.SPLIT_MIN_BYTES <= 2048 ** 2 * 4 * 4


def test_issued_rings_are_the_plain_rings(ranks):
    """Every rank's issued ring, overlapped neighbour sum and overlapped
    Laplacian against ghosted_sharded's, neighbor_sum and laplacian_g,
    each law, split and whole, on the 4-rank meshes and on the 2-rank
    meshes of the first two ranks: bit for bit (the plain rings are the
    whole field's pad, test_torch_shard_mg.py)."""
    for form in ("split", "whole"):
        got = ranks[4]["rings"][form]
        assert {k[0] for k in got} == set(RINGS)
        for key, flags in got.items():
            assert all(bool(f.all()) for f in flags), (form, key)


def test_exchanges_are_issued_before_the_bulk(ranks):
    """The order on rank 0 of the (2, 2) mesh, for every overlapped
    exchange (the step's zeta twice a step, each colour of a relaxation
    sweep, the residual). Split: the exchange is posted, then the bulk's
    three adds run, then its transfers are waited on. Whole (a tile below
    SPLIT_MIN_BYTES): it is posted and waited on before the adds. Every
    other posted exchange is waited on before anything else runs."""
    spy = ranks[4]["spy"]
    for part, n in (("step", 2), ("relax", 2), ("residual", 1)):
        for form, order in (("split", ["post", "add", "add_", "add_",
                                       "wait"]),
                            ("whole", ["post", "wait", "add",
                                       "add", "add"])):
            # a posted batch's works are waited on one after another
            log = [e for i, e in enumerate(spy[form][part])
                   if not (e == "wait" and spy[form][part][i - 1] == "wait")]
            starts = [i for i, e in enumerate(log) if e == "issue"]
            assert len(starts) == n, (form, part)
            for i in starts:
                assert log[i + 1:i + 6] == order, (form, part)
            for i, e in enumerate(log):
                if e == "post" and i - 1 not in starts:
                    assert log[i + 1] == "wait", (form, part)


def _port_steps(kw, limit, monkeypatch):
    """The general-mesh step on the (1, 1) mesh without a group, in this
    process, with halo.SPLIT_MIN_BYTES = limit: (q, psi, tr, diags)."""
    monkeypatch.setattr(halo, "SPLIT_MIN_BYTES", limit)
    fields, psi0, tr0 = inputs(True, n=N)
    cfg = TConfig(**kw).validate()
    const = tqg.build_constants(cfg, device="cpu", **fields)
    state = tqg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
    rs = make_qg_step_sharded(cfg, device="cpu", mode="gspmd", mesh=(1, 1),
                              const=const)
    s, c = rs.shard(state), rs.shard(const)
    diags = []
    for _ in range(STEPS):
        s, d = rs.step(s, c, 1e9)
        diags.append((float(d.dt), float(d.ke), d.mg_iters))
    return s.q, s.psi, s.tracers, diags


@functools.cache
def jax_steps(name):
    """JAX's unsharded make_step of a case, STEPS steps: (q, psi, tr,
    [(dt, ke, cycles)])."""
    fields, psi0, tr0 = inputs(True, n=N)
    cfg = JConfig(**STEP_CASES[name]).validate()
    const = jqg.build_constants(cfg, **fields)
    s = jqg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
    step = jax.jit(jqg.make_step(cfg))
    diags = []
    for _ in range(STEPS):
        s, d = step(s, const, jnp.asarray(1e9))
        diags.append((float(d.dt), float(d.ke), int(d.mg_iters)))
    return np.asarray(s.q), np.asarray(s.psi), np.asarray(s.tracers), diags


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_general_mesh_step_split_and_whole(ranks, name, monkeypatch):
    """The general-mesh step, split and whole, on each mesh: the same
    bits, and JAX's unsharded step within 1e-12."""
    want = jax_steps(name)
    runs = {(1, 1): {f: _port_steps(STEP_CASES[name], limit, monkeypatch)
                     for f, limit in (("split", 0),
                                      ("whole", halo.SPLIT_MIN_BYTES))}}
    for world, meshes in MESHES.items():
        for mesh in meshes:
            got = ranks[world]["steps"][name, mesh]
            runs[mesh] = {f: got[f][:4] for f in ("split", "whole")}
    for mesh, r in runs.items():
        on, off = r["split"], r["whole"]
        for x, y in zip(on[:3], off[:3]):
            assert torch.equal(x, y), mesh
        assert on[3] == off[3], mesh
        check_step(on, want)


def test_solve_layered_sharded_split_and_whole(ranks, monkeypatch):
    """solve_layered_sharded, split and whole, on each mesh (the (1, 1)
    one in this process): the same bits and MGStats, and JAX's unsharded
    solve within 1e-12 in its iteration count."""
    *_, want, iters = jax_mg_problem()
    levels, b, cfg, const = torch_mesh_ranks.mg_problem(MG_KW)
    mesh = make_mesh()
    runs = {}
    for f, limit in (("split", 0), ("whole", halo.SPLIT_MIN_BYTES)):
        monkeypatch.setattr(halo, "SPLIT_MIN_BYTES", limit)
        runs.setdefault((1, 1), {})[f] = shard_mg.solve_layered_sharded(
            torch.zeros_like(b), b, levels=shard_mg.shard_levels(levels,
                                                                 mesh),
            idh0=const.idh0, idh1=const.idh1, bc=tqg._bc_psi(cfg),
            tolerance=MG_TOL)
    for world, meshes in MESHES.items():
        for m in meshes:
            runs[m] = ranks[world]["mg"][m]
    assert set(runs) == {(1, 1), (2, 1), (1, 2), (2, 2), (4, 1)}
    for m, r in runs.items():
        (a1, st1), (a0, st0) = r["split"], r["whole"]
        assert torch.equal(a1, a0) and st1 == st0, m
        assert st1.iters == iters and st1.resa < MG_TOL, m
        assert _rel(a1, want) < 1e-12, m
