"""The port's entry points (msom_tpu_torch.entry) against the JAX package's
(__graft_entry__.py, untouched).

* entry(): the msqg forward step at 256^2 x 3 f32 from the psi of JAX's
  entry() state (JAX's init_state), against JAX's step: q, psi and the KE
  within F32_LIMIT = 1e-4 of their maxima (chip_smoke's LIMITS[4] for
  float32 paths; the two packages' f32 roundoff differs by about 1e-6);
* dryrun_multichip on 8 gloo ranks (JAX's own 2 x 4 mesh, N = 32,
  N_rows = 64), spawned once for the file (tests/torch_mesh_ranks.py's
  "entry" part): float64, every mode (vshard_node with JAX's stochastic
  kick); and vshard_node again with the kick off (entry._node_mode at
  amp_stoch = 0). Each deterministic mode's gathered state within
  1e-12 of max|f| of JAX's unsharded step on the same inputs (computed
  once, in a module-scoped fixture; vshard_node's psi within PSI_LIMIT):
  the msqg modes' q, psi and tracers
  against make_step, vshard_node (kick off, solver="vmg") against make_step,
  wavelet_filter and make_step, gspmd_mspg's b, ux and uy against
  mspg.make_step; each mode within 1e-12 of the port's own unsharded step
  on the same ranks (the run's "rel"); rows_kernel took the rows mode and
  the pencil solve; the summary line is JAX's;
* vshard_node with the kick on, in distribution: its kick (the state
  minus the kick-off run's) against JAX's kick (JAX's run at amp_stoch =
  1e-5 minus its run at 0), both normalised by their RMS;
* where torch sees no card, the entry points refuse device="cuda" rather
  than fall back to the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msom_tpu.models import mspg as jmspg
from msom_tpu.models import qg as jqg
from msom_tpu.models import qg_node as jnode
from msom_tpu.params import PGConfig as JPGConfig
from msom_tpu.params import QGConfig as JConfig
from msom_tpu_torch import entry

import torch_mesh_ranks
from test_torch_node_step import PSI_LIMIT

torch.set_num_threads(1)

WORLD = 8
F32_LIMIT = 1e-4
QG_MODES = {"gspmd": ("gspmd_mg", "gspmd_spectral"),
            "shard_map": ("shard_map_spectral", "shard_map_mg"),
            "rows_kernel": ("rows_kernel",)}


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    """{"dryrun": the float64 dry run, "node_nokick": its vshard_node mode
    with the kick off} of 8 gloo ranks."""
    tmp = tmp_path_factory.mktemp("dryrun")
    return torch_mesh_ranks.run(WORLD, {"entry": "float64"}, tmp)["entry"]


def _jax_node(kick):
    """JAX's unsharded vshard_node run (step, filter, step): (q, psi)."""
    kw, fields, psi0 = entry.node_problem(WORLD, "float64", kick)
    cfg = jnode.NodeQGConfig(**kw, use_pallas=False)
    const = jnode.build_constants(cfg, **fields)
    st = jnode.init_state(cfg, const, psi0=jnp.asarray(psi0))
    step = jax.jit(jnode.make_step(cfg))
    st, _ = step(st, const, jnp.asarray(1e18))
    st = jnode.wavelet_filter(cfg, const, st)
    st, _ = step(st, const, jnp.asarray(1e18))
    return {"q": np.asarray(st.q), "psi": np.asarray(st.psi)}


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's unsharded steps of every mode on the dry run's inputs,
    float64: {mode: {field: array}}; "vshard_node_kick" with the kick."""
    out = {}
    for mode in sum(QG_MODES.values(), ()):
        kw, fields, psi0, tr0 = entry.qg_problem(mode, WORLD, "float64")
        cfg = JConfig(**kw).validate()
        const = jqg.build_constants(cfg, **fields)
        st = jqg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
        st, _ = jax.jit(jqg.make_step(cfg))(st, const,
                                             jnp.asarray(entry.TNEXT))
        out[mode] = {"q": np.asarray(st.q), "psi": np.asarray(st.psi)}
        if cfg.nptr:
            out[mode]["tracers"] = np.asarray(st.tracers)
    out["vshard_node"] = _jax_node(False)
    out["vshard_node_kick"] = _jax_node(True)
    cfg = JPGConfig(**entry.pg_problem(WORLD, "float64"))
    const = jmspg.build_constants(cfg)
    st, _ = jax.jit(jmspg.make_step(cfg))(jmspg.init_state(cfg, const),
                                          const, jnp.asarray(1e9))
    out["gspmd_mspg"] = {k: np.asarray(getattr(st, k))
                         for k in ("b", "ux", "uy")}
    return out


def test_entry_matches_graft_entry():
    """entry() from the psi of JAX's entry() state: q, psi and KE after
    the step within F32_LIMIT of JAX's."""
    import __graft_entry__
    jfn, (jstate, jconst, jtnext) = __graft_entry__.entry()
    jq, jpsi, jke = jax.jit(jfn)(jstate, jconst, jtnext)
    fn, args = entry.entry("cpu", psi0=np.asarray(jstate.psi))
    assert args[0].q.dtype == torch.float32
    q, psi, ke = fn(*args)
    assert q.shape == (3, 256, 256) and bool(torch.isfinite(ke))
    assert _rel(q, jq) < F32_LIMIT
    assert _rel(psi, jpsi) < F32_LIMIT
    assert abs(float(ke) - float(jke)) < F32_LIMIT * abs(float(jke))


def _check_mode(res, mode, want, limits=None):
    r = res["modes"][mode]
    assert set(r["state"]) == set(want), mode
    for k, w in want.items():
        assert _rel(r["state"][k], w) < (limits or {}).get(k, 1e-12), \
            (mode, k)
    assert r["rel"] < 1e-12, mode
    assert np.isfinite(r["ke"]), mode


@pytest.mark.parametrize("group", list(QG_MODES))
def test_dryrun_msqg_modes_match_jax(dryrun, jax_refs, group):
    """The msqg modes on the 2 x 4 mesh (rows_kernel on 8 x 1): the
    gathered state against JAX's unsharded step."""
    res = dryrun["dryrun"]
    for mode in QG_MODES[group]:
        _check_mode(res, mode, jax_refs[mode])
        want = (WORLD, 1) if mode == "rows_kernel" else (2, 4)
        assert tuple(res["modes"][mode]["mesh"]) == want, mode


def test_dryrun_rows_kernel_takes_the_rows_route(dryrun):
    """rows_kernel ran the rows step (the pencil solve, K1 and K2 in rows
    mode: their plain versions on the CPU); the run is JAX's: seven modes
    in JAX's order, a 2 x 4 mesh at N = 32, N_rows = 64, and JAX's line."""
    res = dryrun["dryrun"]
    assert res["modes"]["rows_kernel"]["taken"] == "rows"
    assert list(res["modes"]) == list(entry.MODES)
    assert (res["world"], tuple(res["mesh"]), res["N"], res["N_rows"]) == \
        (8, (2, 4), 32, 64)
    assert res["line"].startswith("dryrun_multichip: ok on 8 ranks (mesh "
                                  "2x4, N=32, gspmd_mg=")


def test_dryrun_vshard_node_matches_jax(dryrun, jax_refs):
    """vshard_node with the kick off (amp_stoch = 0): step, the sharded
    filter, step, against JAX's unsharded run: q within 1e-12, psi within
    tests/test_torch_node_step.py's PSI_LIMIT (JAX's dry-run physics,
    f0 = 46.5: the inversion amplifies q's roundoff in psi, as
    tests/test_torch_vshard.py measured; here 3.8e-12)."""
    r = dryrun["node_nokick"]
    assert r["rel"] < 1e-12
    for k, w in jax_refs["vshard_node"].items():
        assert _rel(r["state"][k], w) < dict(psi=PSI_LIMIT).get(k, 1e-12), k


def test_dryrun_vshard_node_kick_in_distribution(dryrun, jax_refs):
    """vshard_node with the kick on (amp_stoch = 1e-5): the sharded run is
    the port's unsharded run from the same generator seed (the ranks draw
    the whole field alike), within 1e-12; its kick, q minus the kick-off
    run's q on the interior nodes, is a filtered noise as JAX's kick is:
    each normalised by its RMS, |mean| < 0.35 and the two RMS within a
    factor 1.35 of each other (the filter's 12.5 / 3.125 = 4-node
    correlation leaves about 2 x 33^2 / 16 = 136 independent samples:
    four standard errors of a mean and of a ratio of two RMS), and the two
    kicks are different draws."""
    r = dryrun["dryrun"]["modes"]["vshard_node"]
    assert r["rel"] < 1e-12 and np.isfinite(r["ke"])
    inner = (slice(None), slice(1, -1), slice(1, -1))
    kick = (r["state"]["q"] - dryrun["node_nokick"]["state"]["q"]
            ).numpy()[inner]
    jkick = (jax_refs["vshard_node_kick"]["q"]
             - jax_refs["vshard_node"]["q"])[inner]
    rms, jrms = np.sqrt((kick ** 2).mean()), np.sqrt((jkick ** 2).mean())
    assert rms > 0 and jrms > 0
    assert abs(kick.mean()) < 0.35 * rms
    assert abs(jkick.mean()) < 0.35 * jrms
    assert 1 / 1.35 < rms / jrms < 1.35
    assert _rel(kick, jkick) > 0.5


def test_dryrun_mspg_matches_jax(dryrun, jax_refs):
    """gspmd_mspg on the 8 x 1 rows split, one step from rest: b, ux, uy
    against JAX's unsharded step; mean|b| is the run's number."""
    _check_mode(dryrun["dryrun"], "gspmd_mspg", jax_refs["gspmd_mspg"])
    r = dryrun["dryrun"]["modes"]["gspmd_mspg"]
    assert r["ke"] == pytest.approx(np.abs(jax_refs["gspmd_mspg"]["b"])
                                    .mean(), rel=1e-12)


def test_entry_points_refuse_a_missing_card(monkeypatch):
    """Where torch sees no card (made so on any machine), the entry points
    raise where they are not asked for the CPU: entry(),
    dryrun_multichip(), and the CLI without --device cpu (with or without
    --world)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip()
    for argv in ([], ["--world", "2"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry.main(argv)
