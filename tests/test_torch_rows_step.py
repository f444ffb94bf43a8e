"""The rows-sharded msqg step of the port (msom_tpu_torch.parallel) on CPU
ranks in a gloo group (torch.multiprocessing.spawn, a file:// store under
tmp_path), at world sizes 1, 2 and 4 (shards of 64, 32 and 16 rows of a
64^2 x 3 float64 domain): each world size is one spawn whose ranks run
every part (tests/torch_rows_ranks.py), torch and the port only; the
references, the port's unsharded step and the JAX package's, are computed
here, once for the module.

* the step, coupled (psipg or a uniform flow, topography, qforc) with one
  tracer, walled (sbc 0 and 2) and periodic, 4 steps: q, psi and the
  tracers at 1e-12 of their maxima against both unsharded steps, dt equal
  to the port's (and to JAX's at 1e-12, the lockstep tests' tolerance:
  the two packages' own steps differ in dt's last bit), KE at 1e-12
  relative (a sum of the shards' partial sums, whose
  association changes with the world size, tests/test_rows_step.py:138);
* ext_rows8 (wrapped and walled), ghosted_sharded on the (W, 1) mesh
  (the three laws),
  solve_spectral_pencil against solve_spectral (the DST fold and basis,
  the periodic Fourier basis; nl 1 and 3; 1e-13 of max|psi|), pmax, psum,
  fetch_global and broadcast_str at 2 and 4 ranks;
* run_qg(sharded="rows") at world 2 with an OutputWriter on each rank:
  rank 0 writes the unsharded run's .bas records (1e-12 of each file's
  maximum) and rank 1 none;
* a JAX state through convert, shard and gather at world 2, bit for bit;
* the configurations outside the rows path (solver="mg" aside, which the
  rows step now takes) running in the mode the JAX package's run_qg
  records: at world size 1, and a 2 x 2 mesh at world 4 against the
  unsharded steps; the sharded mspg and qg-node runs, once refused, at
  world size 1 against their unsharded runs.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msom_tpu.models import qg as jqg
from msom_tpu.params import QGConfig as JConfig
from msom_tpu_torch import driver as tdriver
from msom_tpu_torch import driver_node as tdn
from msom_tpu_torch.io.bas import read_bas
from msom_tpu_torch.models import mspg as tmspg
from msom_tpu_torch.models import qg as tqg
from msom_tpu_torch.models import qg_node as tqn
from msom_tpu_torch.ops.bc import pad
from msom_tpu_torch.params import PGConfig as TPG
from msom_tpu_torch.params import QGConfig as TConfig
from msom_tpu_torch.parallel import step as pstep
from msom_tpu_torch.solvers import spectral

import torch_rows_ranks

torch.set_num_threads(1)

N, NL, STEPS = 64, 3, 4
FLOW = dict(upg=(0.02, 0.01, 0.0), vpg=(0.01, -0.005, 0.0))
BASE = dict(N=N, nl=NL, L0=80, Rom=0.025, Ekb=0.002, Eks=1e-3, tau0=1e-4,
            Re=500.0, Re4=1563, beta=0.5, Fr=(0.0023669, 0.0076173),
            dh=(0.06, 0.14, 0.8), DT=5e-2, tend=1.0, dtout=1.0, CFL=0.6,
            flsrv=1, solver="spectral", dtype="float64", nptr=1,
            Pe=(1e3,), ptr_r=(100.0,))
CASES = {"walled": dict(sbc=0.0), "slip": dict(sbc=2.0),
         "periodic": dict(sbc=-1.0, **FLOW)}
# the driver run: two output and three filter events, the energy budget
DRIVER = dict(BASE, sbc=0.0, tend=0.6, dtout=0.3, dtflt=0.2, ediag=0)


def _inputs(kw, seed=0):
    rng = np.random.default_rng(seed)
    y = (np.arange(N) + 0.5) * 80.0 / N
    fields = dict(topo=0.05 * np.outer(np.sin(np.pi * y / 80),
                                       np.sin(2 * np.pi * y / 80)),
                  qforc=1e-5 * rng.standard_normal((NL, N, N)))
    if kw.get("sbc", 0.0) != -1.0:
        fields["psipg"] = 1e-3 * rng.uniform(-1, 1, (NL, N, N))
    psi0 = 1e-3 * rng.uniform(-1, 1, (NL, N, N))
    tr0 = 1e-3 * rng.uniform(-1, 1, (NL, 1, N, N))
    return fields, psi0 - psi0.mean(axis=(-2, -1), keepdims=True), tr0


def _job(world, tmp):
    job = {"units": world > 1,
           "steps": {name: (dict(BASE, **kw), *_inputs(kw), STEPS)
                     for name, kw in CASES.items()}}
    if world == 4:
        kw = CASES["slip"]
        job["steps"]["mesh22"] = (dict(BASE, **kw), *_inputs(kw), STEPS,
                                  (2, 2))
    if world == 2:
        fields, psi0, tr0 = _inputs(DRIVER, 5)
        job["driver"] = (DRIVER, fields, psi0, tr0, f"{tmp}/sharded")
        job["roundtrip"] = dict(_jax_leaves())
    return job


@functools.cache
def _jax_leaves():
    """A JAX state with tracers and a filter mean, after one step, as the
    numpy leaves convert takes (and the config under "cfg")."""
    kw = dict(BASE, sbc=0.0, dtflt=0.5)
    jcfg = JConfig(**kw).validate()
    jc = jqg.build_constants(jcfg)
    js = jqg.init_state(jcfg, jc, seed=3)
    js, _ = jax.jit(jqg.make_step(jcfg))(js, jc, jnp.asarray(1e9))
    leaves = {name: np.asarray(getattr(js, name)) for name in
              ("q", "psi", "t", "dt_prev", "i", "tracers", "qof", "nbar")}
    leaves["qof"] = np.random.default_rng(6).standard_normal((NL, N, N))
    return dict(leaves, cfg=kw)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: rank 0's results} for worlds 1, 2 and 4, and the tmp dir."""
    tmp = tmp_path_factory.mktemp("rows")
    return {w: torch_rows_ranks.run(w, _job(w, tmp), tmp)
            for w in (1, 2, 4)}, tmp


@pytest.fixture(scope="module")
def references():
    """{case: (port's unsharded (q, psi, tr, dt, ke), JAX's)} after
    STEPS steps from the same inputs."""
    out = {}
    for name, kw in CASES.items():
        kw = dict(BASE, **kw)
        fields, psi0, tr0 = _inputs(kw)
        tcfg = TConfig(**kw).validate()
        tc = tqg.build_constants(tcfg, device="cpu", **fields)
        ts = tqg.init_state(tcfg, tc, psi0=psi0, tracers0=tr0)
        step = tqg.make_step(tcfg)
        jcfg = JConfig(**kw).validate()
        jc = jqg.build_constants(jcfg, **fields)
        js = jqg.init_state(jcfg, jc, psi0=psi0, tracers0=tr0)
        jstep = jax.jit(jqg.make_step(jcfg))
        for _ in range(STEPS):
            ts, td = step(ts, tc, 1e9)
            js, jd = jstep(js, jc, jnp.asarray(1e9))
        out[name] = ((ts.q.numpy(), ts.psi.numpy(), ts.tracers.numpy(),
                      float(td.dt), float(td.ke)),
                     (np.asarray(js.q), np.asarray(js.psi),
                      np.asarray(js.tracers), float(jd.dt), float(jd.ke)))
    return out


def _rel(got, want):
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_rows_step_matches_unsharded_steps(ranks, references, case, world):
    """The rows step on `world` ranks, 4 steps, against the port's and the
    JAX package's unsharded steps."""
    q, psi, tr, dt, ke, mode = ranks[0][world]["steps"][case]
    assert mode == "rows"
    _check_step((q, psi, tr, dt, ke), references[case])


def _check_step(got, refs, exact_dt=True):
    """(q, psi, tr, dt, ke) against (the port's unsharded step, JAX's): dt
    equal to the port's (or, where the solve's transform differs, within
    1e-12 of it)."""
    q, psi, tr, dt, ke = got
    port, jax_ = refs
    assert dt == port[3] if exact_dt else abs(dt - port[3]) <= 1e-12 * dt
    assert abs(dt - jax_[3]) <= 1e-12 * jax_[3]
    for want in (port, jax_):
        for got, w in zip((q, psi, tr), want[:3]):
            assert _rel(got, w) < 1e-12
        assert abs(ke - want[4]) <= 1e-12 * abs(want[4])


@pytest.mark.parametrize("world", [2, 4])
def test_halo_exchanges_and_reductions(ranks, world):
    """ext_rows8 of rank 0 (its up slab the last rank's rows or zeros),
    ghosted_sharded of rank 0 against the whole field's pad, pmax, psum,
    fetch_global and broadcast_str."""
    from msom_tpu_torch.ops.bc import BC
    u = ranks[0][world]["units"]
    a = torch.as_tensor(np.random.default_rng(1).standard_normal((3, N, N)))
    n = N // world
    for wrap, ext in u["ext"].items():
        up = a[:, -8:] if wrap else torch.zeros_like(a[:, :8])
        assert torch.equal(ext, torch.cat([up, a[:, :n + 8]], 1))
    for bc in (BC.DIRICHLET, BC.NEUMANN, BC.PERIODIC):
        assert torch.equal(u["ghost"][bc.value], pad(a[0], bc)[:n + 2])
    r = torch.arange(world, dtype=torch.float64)
    assert torch.equal(u["pmax"], torch.stack([r.max(), -r.min(),
                                               1.5 * r.max()]))
    assert torch.allclose(u["psum"], torch.stack([r.sum(), -r.sum(),
                                                  1.5 * r.sum()]))
    assert torch.equal(u["fetch"], a)
    assert u["bcast"].item() == world       # broadcast_str on every rank


@pytest.mark.parametrize("world", [2, 4])
def test_pencil_solve_matches_the_whole_solve(ranks, world):
    """solve_spectral_pencil on the ranks, gathered, against the unsharded
    solve_spectral of the same data (the fold and the basis, walled and
    periodic, nl 1 and 3)."""
    for (periodic, transform, nl), got in \
            ranks[0][world]["units"]["pencil"].items():
        kw = dict(dh=np.array([0.06, 0.14, 0.8]),
                  s_profile=np.array([8.96, 0.97])) if nl > 1 else {}
        sd = spectral.build_spectral(nl=nl, N=N, L0=80.0, periodic=periodic,
                                     dtype=torch.float64,
                                     transform=transform, device="cpu", **kw)
        q = torch.as_tensor(np.random.default_rng(2).standard_normal(
            (nl, N, N)))
        want = spectral.solve_spectral(sd, q)
        assert _rel(got, want.numpy()) < 1e-13, (periodic, transform, nl)


def test_run_qg_rows_writes_the_unsharded_records(ranks, tmp_path):
    """run_qg(sharded="rows") at world 2 (filter, energy budget and
    output events): the master's .bas records are the unsharded run's, the
    other rank writes none, and the mode taken is returned."""
    results, tmp = ranks
    q, mode = results[2]["driver"]
    assert mode == "rows"
    fields, psi0, tr0 = _inputs(DRIVER, 5)
    cfg = TConfig(**DRIVER).validate()
    const = tqg.build_constants(cfg, device="cpu", **fields)
    state = tqg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
    hooks = tdriver.RunHooks()
    hooks.on_output = tdriver.OutputWriter(cfg, const,
                                           outdir=str(tmp_path / "single"))
    state, _ = tdriver.run_qg(cfg, const=const, state=state, hooks=hooks,
                              device="cpu")
    assert _rel(q, state.q.numpy()) < 1e-12
    names = sorted(os.listdir(tmp_path / "single"))
    for kind in ("po", "pf", "de_j1", "ptr"):
        assert any(n.startswith(kind) for n in names), kind
    assert sorted(os.listdir(tmp / "sharded" / "rank0")) == names
    for n in names:
        if n.endswith(".bas"):
            a, _, _ = read_bas(str(tmp_path / "single" / n))
            b, _, _ = read_bas(str(tmp / "sharded" / "rank0" / n))
            assert np.abs(b - a).max() <= 1e-12 * max(np.abs(a).max(),
                                                      1e-30), n
    other = os.listdir(tmp / "sharded" / "rank1")
    assert not any(n.startswith(("po", "qo", "pf", "de_")) for n in other)


def test_state_through_convert_shard_and_gather(ranks):
    """A JAX state (tracers, filter mean) through convert, shard and gather
    on 2 ranks comes back bit for bit."""
    leaves = dict(_jax_leaves())
    leaves.pop("cfg")
    got = ranks[0][2]["roundtrip"]
    assert sorted(got) == sorted(leaves)
    for name, want in leaves.items():
        assert np.array_equal(got[name], want), name


def _jax_mode(kw, shape=(1, 1), sharded="auto"):
    """The mode the JAX package's run_qg records for `kw` on a mesh of
    `shape` (no step is taken: tend = 0)."""
    from jax.sharding import Mesh
    from msom_tpu import driver as jdriver
    my, mx = shape
    mesh = Mesh(np.array(jax.devices()[:my * mx]).reshape(my, mx),
                ("y", "x"))
    jdriver.run_qg(JConfig(**dict(kw, tend=0.0)).validate(), sharded=sharded,
                   mesh=mesh)
    return jdriver.run_qg.sharded_mode


@pytest.mark.parametrize("over", [
    pytest.param(dict(solver="mg"), id="over0-shard_mg"),
    pytest.param(dict(mode_pv_invert=True), id="over1-shard_mg"),
    pytest.param(dict(varRo=1), id="over2-GSPMD"),
    pytest.param(dict(N=20), id="over3-GSPMD"),
])
def test_refused_configurations_name_their_item(over):
    """The configurations that item 15 once named (the sharded multigrid,
    the modal inversion, varRo, N % 8 != 0) now run at world size 1, from
    make_qg_step_sharded and from run_qg(sharded=True), in the mode the
    JAX package's run_qg records: "rows" for solver="mg", else "gspmd"
    (at N = 20, where the JAX package builds no constants, its wavelet
    pyramid needing a power of 2, the mode of its routing rule,
    driver.py:197-208: (N / W) % 8 != 0). One step of each matches the
    port's unsharded step. The name, from when these were refused, is
    kept only to keep the test ids: it checks that they run."""
    kw = dict(BASE, **over)
    want = "gspmd" if over.get("N") == 20 else _jax_mode(kw)
    assert want == ("rows" if over.get("solver") == "mg" else "gspmd")
    cfg = TConfig(**kw).validate()
    const = tqg.build_constants(cfg, device="cpu")
    state = tqg.init_state(cfg, const, seed=1)
    rs = pstep.make_qg_step_sharded(cfg, device="cpu", const=const)
    assert rs.mode == want and rs.mesh.shape == (1, 1)
    got, _ = rs.step(rs.shard(state), rs.shard(const), 1e9)
    one, _ = tqg.make_step(cfg)(state, const, 1e9)
    assert _rel(rs.gather(got).q, one.q.numpy()) < 1e-12
    s, _, mode = tdriver.run_qg(cfg, const=const, state=state, max_steps=1,
                                sharded=True, device="cpu")
    assert mode == want and int(s.i) == 1


def test_refused_modes_and_runs_name_their_item(ranks, references,
                                                tmp_path):
    """A 2 x 2 mesh and sharded="gspmd" run, in the mode the JAX package's
    run_qg records ("gspmd"): the 2 x 2 step on 4 ranks against the
    unsharded steps, run_qg(sharded="gspmd") at world size 1 against the
    unsharded run; the sharded mspg run (run_pg(sharded=True)) and the
    sharded qg-node run (run_node(sharded=True)) at world size 1, bit for
    bit their unsharded runs (their arithmetic is the unsharded plain
    versions', term for term). The name, from when the mesh, gspmd and
    these runs were refused, is kept only to keep the test id."""
    assert _jax_mode(BASE, (2, 2)) == "gspmd"
    assert _jax_mode(BASE, sharded="gspmd") == "gspmd"
    q, psi, tr, dt, ke, mode = ranks[0][4]["steps"]["mesh22"]
    assert mode == "gspmd"
    _check_step((q, psi, tr, dt, ke), references["slip"], exact_dt=False)
    kw = dict(BASE, sbc=0.0)
    fields, psi0, tr0 = _inputs(kw)
    cfg = TConfig(**kw).validate()
    out = []
    for sharded in ("gspmd", False):
        const = tqg.build_constants(cfg, device="cpu", **fields)
        state = tqg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
        out.append(tdriver.run_qg(cfg, const=const, state=state,
                                  max_steps=2, sharded=sharded,
                                  device="cpu"))
    assert out[0][2] == "gspmd"
    assert _rel(out[0][0].q, out[1][0].q.numpy()) < 1e-12
    pcfg = TPG(N=16, nl=4, ys=0.3, r=0.02, tau_s=3e-2, tau0=0.12, kv=1e-4,
               kh=1e-4, omega=0.2, DT=1e-2, CFL=0.4, tend=1.0, dtout=0.05,
               dtype="float64")
    pconst = tmspg.build_constants(pcfg, device="cpu")
    b0 = np.linspace(1.0, 0.0, 4)[:, None, None] \
        + 0.2 * np.random.default_rng(9).standard_normal((4, 16, 16))
    runs = [tdriver.run_pg(pcfg, const=pconst,
                           state=tmspg.init_state(pcfg, pconst, b0=b0),
                           max_steps=12, sharded=sharded, device="cpu")
            for sharded in (True, False)]
    for name in ("b", "ux", "uy", "b_me", "ux_me", "uy_me"):
        assert torch.equal(getattr(runs[0], name), getattr(runs[1], name))
    ncfg = tqn.NodeQGConfig(N=16, nl=3, L0=100.0, f0=10.0, beta=0.1,
                            hEkb=1e-3, tau0=1e-3, nu=5.0, dh=(0.2, 0.3, 0.5),
                            N2=(1.0, 2.0), bc_fac=1.0, DT=5e-2, CFL=0.2,
                            TOLERANCE=1e-10, tend=0.05, dtout=0.05,
                            solver="vmg", dtype="float64")
    nconst = tqn.build_constants(ncfg, device="cpu",
                                 mask=tqn.coastline_mask(16))
    psi0 = 1e-3 * np.random.default_rng(2).uniform(-1, 1, (3, 17, 17))
    nodes = [tdn.run_node(ncfg, const=nconst,
                          state=tqn.init_state(ncfg, nconst, psi0=psi0),
                          outdir=str(tmp_path / str(sharded)),
                          restart=None, sharded=sharded, device="cpu")[0]
             for sharded in (True, False)]
    assert int(nodes[0].i) == int(nodes[1].i) >= 3
    assert torch.equal(nodes[0].q, nodes[1].q)
    assert torch.equal(nodes[0].psi, nodes[1].psi)


def test_stochastic_rows_step_at_world_1_draws_the_unsharded_noise():
    """A stochastic rows step at world size 1 (no group) seeds its rank's
    generator from (seed, 0) as the unsharded run seeds its own from seed:
    the same noise, so the same state (the ranks of a larger world draw
    their own streams, equal in distribution only)."""
    kw = dict(BASE, sbc=0.0, stochastic=True, tr_stoch=50.0, amp_stoch=1e-6)
    fields, psi0, tr0 = _inputs(kw)
    cfg = TConfig(**kw).validate()
    const = tqg.build_constants(cfg, device="cpu", **fields)
    state = tqg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
    rs = pstep.make_qg_step_sharded(cfg, device="cpu", seed=5)
    step = tqg.make_step(cfg, torch.Generator().manual_seed(5))
    a, b, c = state, rs.shard(state), rs.shard(const)
    for _ in range(STEPS):
        a, _ = step(a, const, 1e9)
        b, _ = rs.step(b, c, 1e9)
    assert _rel(b.q, a.q.numpy()) < 1e-12
    assert _rel(b.tracers, a.tracers.numpy()) < 1e-12


def test_cli_sharded_runs_the_rows_step(tmp_path, capsys):
    """`--sharded` without torchrun's environment runs the rows step at
    world size 1, the same steps and model time as the unsharded CLI."""
    deck = tmp_path / "params.in"
    deck.write_text("N = 64\nnl = 3\nL0 = 80.\nRom = 0.025\nEkb = 0.002\n"
                    "tau0 = 1e-4\nRe4 = 391\nbeta = 0.5\n"
                    "Fr = [0.0023669,0.0076173]\ndh = [0.06,0.14,0.8]\n"
                    "DT = 5e-2\ntend = 500.\ndtout = 10.\nCFL = 0.6\n"
                    "solver = spectral\n")
    common = ["--config", str(deck), "--cpu", "--no-output", "--steps", "3"]
    one = tdriver.main(common)
    rows = tdriver.main(common + ["--sharded", "--sharded-mode", "rows"])
    assert rows["ranks"] == 1 and rows["steps"] == one["steps"] == 3
    assert rows["t"] == one["t"]
