"""The vertex-sharded qg-node run of the port (msom_tpu_torch.parallel.vshard
and driver_node.run_node(sharded=True)) on CPU ranks in a gloo group on a
file:// store under tmp_path, at world sizes 1, 2 and 4: the meshes
(1, 1), (2, 1), (1, 2) and (2, 2) of a 16^2 float64 grid. A world size is
one spawn (world size 1: the test's own process) whose ranks run every
part (tests/torch_vshard_ranks.py), torch and the port only; the JAX
references are computed here, once for the module, from the JAX package's
unsharded model with solver="vmg" (tests/test_shard_vertex.py:27-38, with
f0 = 10: at its f0 = 46.5, S2 = 2162, a random 1-ulp relative change of q
moves psi by 2e-10 of its maximum in these 3-layer inversions (measured),
so psi could not be held to PSI_LIMIT however exactly q agrees; at f0 = 10
the same change moves it by 6e-12).

Eight tests, each looping over the meshes (a file of fewer than nine
tests is queued after tests/test_shard_vertex.py, tier-1's longest, by
pytest-xdist's order of files by their number of tests):

* vpoisson_sharded, rhs_pv_sharded and diag_1d_sharded on each mesh
  against JAX's invert_q (the vertex multigrid), rhs_pv and diag_1d on the
  same inputs: 1e-12 of their maxima, the V-cycles equal;
* the sharded step for nl = 1 and 3, bc_fac 0 and 1, nu4 > 0, a coastline
  mask, psi_pg, topography with a 3-D forcing and the filter event, three
  steps, against JAX's make_step and wavelet_filter: q within 1e-12 of its
  maximum, psi within tests/test_torch_node_step.py's PSI_LIMIT, and psi_f,
  the filter's mean of a psi, within the same on the owned nodes (its
  dropped ring is zero in the sharded run, as in JAX's), dt at rtol 1e-12;
* q and psi of a case the same bits on the four meshes, and the same bits
  as the port's unsharded step (the sharded arithmetic is its plain
  version's, term for term); the stochastic step draws the unsharded noise,
  bit for bit;
* JAX's own shard_map step (msom_tpu.parallel.vshard) on its 2 x 2 CPU
  mesh, two steps, against the port's (2, 2) step at 1e-12, and its
  owned-rep state with its VertexRing through vshard.to_full and
  convert's node path into the port and back;
* run_node(sharded=True) at worlds 1, 2 and 4 against JAX's run_node: its
  vars.nc within float32 rounding and its diag_1d.dat to the printed
  digits (tests/test_drivers_node.py:147-175);
* a periodic config raises the JAX package's NotImplementedError.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from msom_tpu import driver_node as jdn
from msom_tpu.models import qg_node as jnode
from msom_tpu.parallel import vshard as jvshard
from msom_tpu_torch import convert
from msom_tpu_torch.models import qg_node as tnode
from msom_tpu_torch.parallel import vshard
from msom_tpu_torch.parallel.mesh import make_mesh

import torch_vshard_ranks
from test_torch_driver_node import same_vars_nc
from test_torch_node_step import PSI_LIMIT

torch.set_num_threads(1)

N = 16
M = N + 1
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]
WORLD = {(1, 1): 1, (2, 1): 2, (1, 2): 2, (2, 2): 4}


def kw_(nl, bc_fac, nu4=0.0, **kw):
    """tests/test_shard_vertex.py's configuration at N = 16."""
    base = dict(N=N, nl=nl, L0=100.0, f0=10.0, beta=0.5, hEkb=1e-3,
                tau0=1e-3, tau1=5e-4, tf1=2.0, tf2=3.0, dy_ws=0.3, nu=5.0,
                nu4=nu4, dh=tuple([1.0 / nl] * nl),
                N2=tuple([1.0] * max(nl - 1, 1)), noise_init=1e-3,
                bc_fac=bc_fac, DT=5e-2, tend=1.0, dtout=1.0, CFL=0.2,
                TOLERANCE=1e-8, solver="vmg", dtype="float64",
                use_pallas=False)
    base.update(kw)
    return base


def fields_(nl, seed=0, pg=True, mask=True):
    """Topography, a 3-D forcing, psi_pg (its ring nonzero) and the
    coastline mask."""
    rng = np.random.default_rng(seed)
    f = dict(topo=0.1 * rng.uniform(-1, 1, (M, M)),
             q_forcing_3d=1e-4 * rng.standard_normal((nl, M, M)))
    if pg:
        f["psi_pg"] = 1e-3 * rng.uniform(-1, 1, (nl, M, M))
    if mask:
        f["mask"] = tnode.coastline_mask(N)
    return f


def psi0_(nl, seed=3):
    rng = np.random.default_rng(seed)
    y = np.arange(M)[:, None] * 100.0 / N
    return 1e-3 * (rng.uniform(-1, 1, (nl, M, M))
                   + np.sin(2 * np.pi * y / 100.0))


FILTER = dict(dtflt=0.5, Lfmax=30.0, Lfmin=10.0)
# {name: (config kwargs, fields, plan: "s" a step, "f" the filter event)}
CASES = {
    "nl1_noslip": (kw_(1, 1.0), {}, "sss"),
    "nl3_coast_pg_topo": (kw_(3, 0.0), fields_(3), "sss"),
    "nl3_noslip_nu4_filter": (kw_(3, 1.0, 1e-5, **FILTER),
                              fields_(3, pg=False), "ssfs"),
}
STOCH = (kw_(3, 1.0, stochastic=True, amp_stoch=1e-3, L_filt_stoch=20.0),
         fields_(3, mask=False), "sss")
UNITS = ("nl1_noslip", "nl3_coast_pg_topo")
UNIT_T = 0.3
# run_node on the filter case's physics: output at t = 0, 0.02, 0.04,
# diag rows every 0.01, the filter at 0.03 (dt clamps to 0.01: 4 steps)
DRIVER_CASE = "nl3_noslip_nu4_filter"
DRIVER = (dict(CASES[DRIVER_CASE][0], tend=0.04, dtout=0.02, dtdiag=0.01,
               dtflt=0.03), CASES[DRIVER_CASE][1])
JAX_VSHARD = "nl1_noslip"


@functools.cache
def _jax_const(name):
    """JAX's constants of a case, built once (they do not depend on the
    event times)."""
    kw, fields, _ = CASES[name]
    return jnode.build_constants(jnode.NodeQGConfig(**kw), **fields)


def jax_problem(name, kw=None):
    """(cfg, const, state) of a case in the JAX package, `kw` replacing the
    case's configuration (event times only)."""
    kw = CASES[name][0] if kw is None else kw
    cfg, const = jnode.NodeQGConfig(**kw), _jax_const(name)
    return cfg, const, jnode.init_state(cfg, const,
                                        psi0=jnp.asarray(psi0_(kw["nl"])))


@pytest.fixture(scope="module")
def references():
    """JAX's unsharded results: {"units": {case: (psi, iters, dq, diag)},
    "steps": {case: (q, psi, psi_f, dts)}}."""
    out = {"units": {}, "steps": {}}
    for name in UNITS:
        cfg, const, st = jax_problem(name)
        psi, it = jnode.invert_q(cfg, const, st.psi, st.q)
        t = jnp.asarray(UNIT_T)
        dq = jnode.rhs_pv(cfg, const, st.q, psi, t)
        diag = jnode.diag_1d(cfg, const, psi, st.q, t)
        out["units"][name] = (np.asarray(psi), int(it.iters),
                              np.asarray(dq), tuple(float(x) for x in diag))
    for name, (_, _, plan) in CASES.items():
        cfg, const, st = jax_problem(name)
        step = jax.jit(jnode.make_step(cfg))
        dts = []
        for act in plan:
            if act == "f":
                st = jnode.wavelet_filter(cfg, const, st)
            else:
                st, d = step(st, const, jnp.asarray(1e18))
                dts.append(float(d.dt))
        out["steps"][name] = (np.asarray(st.q), np.asarray(st.psi),
                              None if st.psi_f is None
                              else np.asarray(st.psi_f), dts)
    return out


def _job(world, tmp, refs):
    """The ranks' job at `world`: the units on JAX's psi, the cases' steps
    (the stochastic one too) and the JAX vshard comparison's two steps on
    the world's meshes, and the run_node run."""
    units, steps = {}, {}
    for s in (s for s in MESHES if WORLD[s] == world):
        for name in UNITS:
            kw, fields, _ = CASES[name]
            units[name, s] = (s, kw, fields, psi0_(kw["nl"]),
                              refs["units"][name][0], UNIT_T)
        for name, (kw, fields, plan) in {**CASES,
                                         "stochastic": STOCH}.items():
            steps[name, s] = (s, kw, fields, psi0_(kw["nl"]), plan, 5)
        if s == (2, 2):
            kw, fields, _ = CASES[JAX_VSHARD]
            steps["jax_vshard", s] = (s, kw, fields, psi0_(kw["nl"]), "ss",
                                      0)
    kw, fields = DRIVER
    return {"units": units, "steps": steps,
            "driver": {"run": (kw, fields, psi0_(3), f"{tmp}/port{world}",
                               None)}}


@pytest.fixture(scope="module")
def ranks(references, tmp_path_factory):
    """{world: rank 0's results} for worlds 1, 2 and 4, and the directory
    of the runs' files."""
    tmp = tmp_path_factory.mktemp("vshard")
    return {w: torch_vshard_ranks.run(w, _job(w, tmp, references), tmp)
            for w in (1, 2, 4)}, tmp


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _owned(a):
    return np.asarray(a)[..., :-1, :-1]


def test_vpoisson_rhs_diag_match_jax(ranks, references):
    """On each mesh, for each unit case: vpoisson_sharded of q from the
    state's psi, psi within 1e-12 of its maximum and the same V-cycles;
    rhs_pv_sharded and diag_1d_sharded of JAX's psi within 1e-12 (diag
    relative: a sum over the ranks' tiles)."""
    for shape in MESHES:
        for name in UNITS:
            psi, iters, dq, diag = \
                ranks[0][WORLD[shape]]["units"][name, shape]
            j_psi, j_iters, j_dq, j_diag = references["units"][name]
            where = (name, shape)
            assert iters == j_iters, where
            assert _rel(psi, _owned(j_psi)) < 1e-12, where
            assert _rel(dq, _owned(j_dq)) < 1e-12, where
            for got, want in zip(diag, j_diag):
                assert abs(got - want) <= 1e-12 * abs(want), where


def _port_unsharded(kw, fields, plan, seed):
    """The port's unsharded run of a case's plan (its plain versions on
    the CPU)."""
    cfg, const, st = torch_vshard_ranks.node_problem(kw, fields,
                                                     psi0_(kw["nl"]))
    gen = torch.Generator().manual_seed(seed) if cfg.stochastic else None
    step = tnode.make_step(cfg, gen)
    for act in plan:
        if act == "f":
            st = tnode.wavelet_filter(cfg, const, st)
        else:
            st, _ = step(st, const, 1e18)
    return st


def _same_bits_on_every_mesh(ranks, name, want):
    """q and psi of a case the same bits on the four meshes and as the
    port's unsharded run `want`."""
    for shape in MESHES:
        q, psi, _, _ = ranks[0][WORLD[shape]]["steps"][name, shape]
        assert torch.equal(q, want.q), shape
        assert torch.equal(psi, want.psi), shape


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_jax(ranks, references, name):
    """Three steps (the filter event among them where the case has one)
    on each mesh against JAX's unsharded make_step and wavelet_filter;
    and q and psi the same bits on the four meshes and as the port's
    unsharded run: every ghost is the neighbour's value, the reductions
    that feed the state are maxima, and every operation is the unsharded
    plain version's, in its order."""
    jq, jpsi, jpsi_f, jdts = references["steps"][name]
    for shape in MESHES:
        q, psi, psi_f, diags = ranks[0][WORLD[shape]]["steps"][name, shape]
        assert _rel(q, jq) < 1e-12, shape
        assert _rel(psi, jpsi) < PSI_LIMIT, shape
        if jpsi_f is not None:
            assert _rel(_owned(psi_f), _owned(jpsi_f)) < PSI_LIMIT, shape
            assert not psi_f[..., -1, :].any()
            assert not psi_f[..., :, -1].any()
        assert len(diags) == len(jdts)
        for (dt, _, _), jdt in zip(diags, jdts):
            assert abs(dt - jdt) <= 1e-12 * jdt, shape
    kw, fields, plan = CASES[name]
    _same_bits_on_every_mesh(ranks, name,
                             _port_unsharded(kw, fields, plan, 5))


def test_stochastic_step_draws_the_unsharded_noise(ranks):
    """The stochastic case draws the whole noise on every rank from a
    generator seeded alike, so its kick is the unsharded draw: q and psi
    the same bits on the four meshes and as the port's unsharded run from
    the same seed."""
    kw, fields, plan = STOCH
    _same_bits_on_every_mesh(ranks, "stochastic",
                             _port_unsharded(kw, fields, plan, 5))


def test_jax_vshard_on_a_2x2_mesh_matches_the_port(ranks):
    """JAX's own sharded step (msom_tpu.parallel.vshard under shard_map on
    its 2 x 2 CPU mesh), two steps, against the port's (2, 2) step at
    1e-12. The case has no psi_pg: JAX's sharded step gives psi_pg zero
    ghosts at the dropped ring, where the port reads psi_pg's own ring (a
    nonzero ring there is a fault of the JAX package's that the port does
    not share). JAX's owned-rep state and its VertexRing carry into the
    port through vshard.to_full and convert's node path, and back to the
    owned rep bit for bit."""
    cfg, const, st = jax_problem(JAX_VSHARD)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("y", "x"))
    own0 = jvshard.owned_state(st)
    step, place, csh = jvshard.make_node_step_sharded(
        cfg, mesh, const, np.asarray(st.q), own0)
    s = place(own0)
    for _ in range(2):
        s, d = step(s, csh, jnp.asarray(1e18))
    q, psi, _, diags = ranks[0][4]["steps"]["jax_vshard", (2, 2)]
    assert _rel(_owned(q), np.asarray(s.q)) < 1e-12
    assert _rel(_owned(psi), np.asarray(s.psi)) < PSI_LIMIT
    assert abs(diags[-1][0] - float(d.dt)) <= 1e-12 * float(d.dt)

    def full(x, **ring):
        return vshard.to_full(torch.as_tensor(np.asarray(x)), **{
            k: torch.as_tensor(np.asarray(v)) for k, v in ring.items()})

    leaves = {"q": full(s.q, ring_row=csh.ring.q_top,
                        ring_col=csh.ring.q_right).numpy(),
              "psi": full(s.psi).numpy(), "t": np.asarray(s.t),
              "dt_prev": np.asarray(s.dt_prev), "i": np.asarray(s.i),
              "nbar": np.asarray(s.nbar)}
    port = convert.node_state_from_numpy(tnode.NodeQGConfig(
        **CASES[JAX_VSHARD][0]), leaves, device="cpu")
    assert _rel(port.q, q) < 1e-12
    assert torch.equal(port.q[..., -1, :], q[..., -1, :])
    assert torch.equal(port.q[..., :, -1], q[..., :, -1])
    back = vshard.owned_state(port)
    assert np.array_equal(back.q.numpy(), np.asarray(s.q))
    assert np.array_equal(back.psi.numpy(), np.asarray(s.psi))
    assert int(port.i) == 2


@pytest.fixture(scope="module")
def jax_run(ranks, tmp_path_factory):
    """JAX's run_node of the DRIVER case: its output directory."""
    tmp = tmp_path_factory.mktemp("vshard_jax")
    cfg, const, st = jax_problem(DRIVER_CASE, DRIVER[0])
    jdn.run_node(cfg, const=const, state=st, outdir=str(tmp), restart=None)
    return str(tmp)


def _diag_rows(path):
    with open(os.path.join(path, "diag_1d.dat")) as f:
        lines = f.read().splitlines()
    return lines[0], np.array([[float(v) for v in l.split(",")]
                               for l in lines[1:]])


def test_run_node_sharded_matches_jax(ranks, jax_run):
    """run_node(sharded=True) on 1, 2 and 4 ranks, its files written by
    the master: vars.nc (three records) within float32 rounding of JAX's
    run_node's and diag_1d.dat (four rows) to its printed digits; the
    returned whole q within float32 rounding of the last record."""
    results, tmp = ranks
    jhead, jrows = _diag_rows(jax_run)
    for world in (1, 2, 4):
        port = str(tmp / f"port{world}")
        fields, times = same_vars_nc(os.path.join(port, "vars.nc"),
                                     os.path.join(jax_run, "vars.nc"))
        assert len(times) == 3, world
        head, rows = _diag_rows(port)
        assert head == jhead and rows.shape == jrows.shape == (4, 4)
        np.testing.assert_allclose(rows, jrows, rtol=5e-7, atol=0)
        q, _ = results[world]["driver"]["run"]
        assert np.abs(q.numpy() - fields["q"][-1]).max() \
            <= 2.0 ** -23 * np.abs(fields["q"][-1]).max(), world
        assert sorted(os.listdir(port)) == ["diag_1d.dat", "vars.nc"]


def test_periodic_config_raises_jax_error():
    """vertex sharding covers walled grids: the JAX package's
    NotImplementedError, from run_node and from shard_const."""
    kw = kw_(1, -1.0)
    cfg = tnode.NodeQGConfig(**kw)
    const = tnode.build_constants(cfg, device="cpu")
    state = tnode.init_state(cfg, const, psi0=psi0_(1)[..., :-1, :-1])
    from msom_tpu_torch import driver_node as tdn
    for call in (lambda: tdn.run_node(cfg, const=const, state=state,
                                      sharded=True, device="cpu"),
                 lambda: vshard.shard_const(cfg, const, state.q,
                                            make_mesh((1, 1)))):
        with pytest.raises(NotImplementedError,
                           match="vertex sharding covers wall domains"):
            call()
