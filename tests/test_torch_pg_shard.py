"""The sharded mspg run of the port (msom_tpu_torch.parallel.pg_step and
driver.run_pg(sharded=True)) on CPU ranks in a gloo group
(torch.multiprocessing.spawn, a file:// store under tmp_path) at world
sizes 2 and 4, one spawn a world (tests/torch_vshard_ranks.py), torch and
the port only; the JAX references, the JAX package's run_pg, are computed
here, once for the module.

* run_pg(sharded=True), 12 steps at tests/test_parallel.py:188-206's
  32^2 x 4 configuration, against JAX's run_pg: b and b_me within 1e-12
  of max|b| (that test's bound), ux, uy and their means within 1e-12 of
  their maxima; and bit for bit the port's unsharded run_pg (the rows
  step's arithmetic is the unsharded step's, term for term);
* the output events of a 16^2 x 4 run with a PGOutputWriter on the
  master: its files against JAX's writer's within float32 rounding, the
  running means gathered from the ranks' rows;
* the grid rule: N = 24 cuts into 2 and 4 ranks, N = 27 does not (a
  ValueError naming the reason), and neither does a grid of fewer than
  2 rows a rank.

Eight tests (a file of fewer than nine is queued after
tests/test_shard_vertex.py, tier-1's longest, by pytest-xdist's order of
files by their number of tests).
"""

import numpy as np
import pytest
import torch

from msom_tpu import driver as jdriver
from msom_tpu.params import PGConfig as JPG
from msom_tpu_torch import driver as tdriver
from msom_tpu_torch.models import mspg as tm
from msom_tpu_torch.parallel.pg_step import rows_refusal
from msom_tpu_torch.params import PGConfig as TPG

import torch_vshard_ranks
from test_torch_driver import same_files

torch.set_num_threads(1)

PARALLEL = dict(N=32, nl=4, ys=0.3, r=0.02, tau_s=3e-2, tau0=0.12, kv=1e-4,
                kh=1e-4, omega=0.2, DT=1e-2, CFL=0.4, tend=1.0, dtout=10.0,
                dtype="float64")
STEPS = 12
# the output run: events at t = 0, 0.05, 0.1 (tests/test_torch_driver_pg.py
# 's physics)
OUTPUT = dict(PARALLEL, N=16, tend=0.1, dtout=0.05)
FIELDS = ("b", "ux", "uy", "b_me", "ux_me", "uy_me")
GRIDS = {24: None, 27: "not divisible"}


def b0_(kw, seed=9):
    rng = np.random.default_rng(seed)
    return (np.linspace(1.0, 0.0, kw["nl"])[:, None, None]
            + 0.2 * rng.standard_normal((kw["nl"], kw["N"], kw["N"])))


def _job(world, tmp):
    return {"pg": {"run": (PARALLEL, b0_(PARALLEL), STEPS, None),
                   "output": (OUTPUT, b0_(OUTPUT), None,
                              f"{tmp}/port{world}"),
                   **{N: (dict(PARALLEL, N=N), None, None, None)
                      for N in GRIDS}}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """({world: rank 0's results}, the runs' directory)."""
    tmp = tmp_path_factory.mktemp("pg_shard")
    return {w: torch_vshard_ranks.run(w, _job(w, tmp), tmp)["pg"]
            for w in (2, 4)}, tmp


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's run_pg of PARALLEL (its final state) and of OUTPUT (its
    writer's directory)."""
    cfg = JPG(**PARALLEL)
    from msom_tpu.models import mspg as jm
    const = jm.build_constants(cfg)
    s = jdriver.run_pg(cfg, const=const,
                       state=jm.init_state(cfg, const, b0=b0_(PARALLEL)),
                       max_steps=STEPS)
    tmp = tmp_path_factory.mktemp("pg_shard_jax")
    ocfg = JPG(**OUTPUT)
    oconst = jm.build_constants(ocfg)
    writer = jdriver.PGOutputWriter(ocfg, oconst, outdir=str(tmp))
    jdriver.run_pg(ocfg, const=oconst,
                   state=jm.init_state(ocfg, oconst, b0=b0_(OUTPUT)),
                   hooks=jdriver.RunHooks(on_output=writer))
    return {k: np.asarray(getattr(s, k)) for k in FIELDS + ("t",)}, str(tmp)


def _scaled_err(got, want, scale):
    return np.abs(got.numpy() - want).max() / scale


@pytest.mark.parametrize("world", [2, 4])
def test_run_pg_sharded_matches_jax(ranks, jax_run, world):
    got = ranks[0][world]["run"]
    want, _ = jax_run
    scale = np.abs(want["b"]).max()
    assert int(got["i"]) == STEPS and int(got["nme"]) == 1
    assert abs(float(got["t"]) - float(want["t"])) <= 1e-12
    assert _scaled_err(got["b"], want["b"], scale) < 1e-12
    assert _scaled_err(got["b_me"], want["b_me"], scale) < 1e-12
    for name in ("ux", "uy", "ux_me", "uy_me"):
        assert _scaled_err(got[name], want[name],
                           np.abs(want[name]).max()) < 1e-12, name


@pytest.mark.parametrize("world", [2, 4])
def test_run_pg_sharded_is_bitwise_the_unsharded_run(ranks, world):
    cfg = TPG(**PARALLEL)
    const = tm.build_constants(cfg, device="cpu")
    want = tdriver.run_pg(cfg, const=const,
                          state=tm.init_state(cfg, const, b0=b0_(PARALLEL)),
                          max_steps=STEPS, device="cpu")
    got = ranks[0][world]["run"]
    for name in FIELDS:
        assert torch.equal(got[name], getattr(want, name)), name
    assert got["uy"].shape == (4, 33, 32)


@pytest.mark.parametrize("world", [2, 4])
def test_run_pg_sharded_writes_the_jax_files(ranks, jax_run, world):
    """psibt.bas, then the b and u means at t = 0, 0.05 and 0.1, from the
    master only, within float32 rounding of JAX's writer's."""
    _, tmp = ranks
    names = same_files(tmp / f"port{world}", jax_run[1])
    assert sum(n.startswith("b0") for n in names) == 3
    assert "psibt.bas" in names
    assert int(ranks[0][world]["output"]["i"]) >= 10


def test_grid_rule(ranks):
    """A dividing N runs on 2 and 4 ranks; a non-dividing one raises
    ValueError naming the reason (the JAX package leaves such an axis
    unsharded instead)."""
    for world in (2, 4):
        for N, why in GRIDS.items():
            got = ranks[0][world][N]
            if why is None:
                assert got is None, (world, N)
            else:
                assert got[:2] == ("raises", "ValueError"), (world, N)
                assert why in got[2] and f"{world} ranks" in got[2]


def test_rows_refusal():
    for N, world, why in ((32, 4, None), (64, 32, None),
                          (30, 4, "not divisible"), (4, 4, "leaves 1 row"),
                          (2, 4, "not divisible")):
        got = rows_refusal(N, world)
        assert got is None if why is None else why in got, (N, world)
