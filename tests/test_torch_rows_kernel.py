"""The rows mode of K1 and K2 (the shard of a rows decomposition, halo
slabs from the y-neighbours, walls keyed on the global row): the port's
plain rows versions (fused_rhs.rhs_fused / fused_tracer.tracer_fused with
psi_ext, q_ext, tr_ext and row0 on CPU tensors) against the JAX package's
rows-mode Pallas kernels in interpret mode, sliced per shard by hand as
tests/test_rows_step.py:56-116 slices them; the port's shards put
together against its whole-domain plain versions; and the rows mode of
the kernels' CUDA sources in the host emulation (tools/k1_emulation.py,
tools/strip_emulation.py) on virtual shards, walled and periodic, f64 and
f32, with shards of 24 rows (a partial strip) and 16.

Tolerances: dq and dtr against JAX at 1e-12 of max|out| (float64, the
sums in another order), umax at 1e-15 relative (the JAX kernel multiplies
by 1/(2 delta) where the plain version divides); the put-together shards
against the whole domain bitwise (the same operations on the same
values)."""

import dataclasses
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msom_tpu.models import pallas_rhs
from msom_tpu.models import qg as jqg
from msom_tpu.params import QGConfig as JConfig
from msom_tpu_torch.models import fused_rhs, fused_tracer
from msom_tpu_torch.models import qg as tqg
from msom_tpu_torch.params import QGConfig as TConfig
from msom_tpu_torch.parallel import halo

torch.set_num_threads(1)

N, NL, NDEV = 64, 3, 2
_yy = np.linspace(0.0, 80.0, N)
_PP = 1e-3 * np.stack([np.sin(np.pi * _yy / 80.0)[None, :]
                       * np.ones((N, N)) for _ in range(NL)])
_TOPO = 0.05 * np.outer(np.sin(np.pi * _yy / 80.0),
                        np.sin(2 * np.pi * _yy / 80.0))
FLOW = dict(upg=(0.02, 0.01, 0.0), vpg=(0.01, -0.005, 0.0))
TRACER = dict(nptr=2, Pe=(1e3, 2e3), ptr_r=(100.0, 0.0))
# (sbc, options): walled coupled with free and partial slip (the cases of
# tests/test_rows_step.py), ENERGY_CONSERV, stochastic, and the periodic
# domain with pp from a uniform flow, _LS_RV, topography and qforc
CASES = {
    "walled": (0.0, {}),
    "slip": (2.0, {}),
    "energy_conserv": (0.0, dict(energy_conserv=True)),
    "stochastic": (0.0, dict(stochastic=True, tr_stoch=50.0, flsrv=0)),
    "periodic": (-1.0, dict(Eks=0.0, **FLOW)),
}


def _configs(sbc, **kw):
    base = dict(N=N, nl=NL, L0=80, Rom=0.025, Ekb=0.002, Eks=1e-3,
                tau0=1e-4, Re=500.0, Re4=1563, beta=0.5, sbc=sbc,
                Fr=(0.0023669, 0.0076173), dh=(0.06, 0.14, 0.8),
                DT=5e-2, tend=1.0, dtout=1.0, CFL=0.6, flsrv=1,
                solver="spectral", dtype="float64", **TRACER)
    base.update(kw)
    return JConfig(**base).validate(), TConfig(**base).validate()


def _inputs(sbc):
    rng = np.random.default_rng(3)
    fields = dict(topo=_TOPO, qforc=1e-4 * rng.standard_normal((NL, N, N)),
                  ptr_relax=rng.uniform(-1, 1, (NL, 2, N, N)))
    if sbc != -1.0:
        fields["psipg"] = _PP
    psi = np.random.default_rng(0).standard_normal((NL, N, N))
    tr = np.random.default_rng(1).standard_normal((NL, 2, N, N))
    return fields, psi, tr


def _jax_rows(jcfg, jc, psi, q, tr):
    """The JAX rows-mode kernels on NDEV shards, each handed its slices as
    shard_map hands them (pallas_rhs.rows_specs): (dq, umax, dtr) put
    together."""
    need_q = bool(jcfg.stochastic or jcfg.energy_conserv)
    s_np = np.asarray(jc.strl)
    kd = pallas_rhs.build_kernel_data(
        jcfg, np.asarray(jc.wind), s_np[..., 0], Ro=np.asarray(jc.Ro),
        pp_pad=jc.pp_pad, topo_pad=jc.topo_pad, zetap_pad=jc.zetap_pad,
        need_q=need_q, has_qforc=jc.qforc is not None, rows=NDEV)
    assert kd is not None and kd.Ttr > 0
    n = N // NDEV
    wrap = jcfg.sbc == -1

    def ext(a):
        return [jnp.asarray(e.numpy())
                for e in halo.split_rows8(torch.as_tensor(np.array(a)),
                                          NDEV, wrap)]

    def part(a, d, axis):
        if a is None:
            return None
        k = a.shape[axis] // NDEV
        return jnp.take(a, jnp.arange(d * k, (d + 1) * k), axis=axis)

    p_ext, q_ext = ext(psi), ext(q)
    t_ext = ext(np.asarray(tr).reshape(NL * 2, N, N))
    dqs, ums, dtrs = [], [], []
    for d in range(NDEV):
        kd_loc = dataclasses.replace(
            kd, **{f: part(getattr(kd, f), d, 0)
                   for f in ("strl", "wind", "iro")},
            **{f: part(getattr(kd, f), d, 1)
               for f in ("pp", "topo", "pp_ext", "topo_ext", "pp_t",
                         "zetap_t")})
        c_loc = dataclasses.replace(jc, rhsk=kd_loc,
                                    qforc=part(jc.qforc, d, 1),
                                    ptr_relax=part(jc.ptr_relax, d, 2))
        rows = slice(d * n, (d + 1) * n)
        dq, um = pallas_rhs.rhs_fused(
            jcfg, c_loc, psi[:, rows], q[:, rows] if need_q else None,
            interpret=True, psi_ext=p_ext[d],
            q_ext=q_ext[d] if need_q else None, row0=d * n)
        dtr = pallas_rhs.tracer_fused(
            jcfg, c_loc, psi[:, rows], tr[..., rows, :], interpret=True,
            psi_ext=p_ext[d], tr_ext=t_ext[d], row0=d * n)
        dqs.append(np.asarray(dq))
        ums.append(np.asarray(um))
        dtrs.append(np.asarray(dtr))
    return (np.concatenate(dqs, 1), np.max(ums, 0),
            np.concatenate(dtrs, 2))


def _port_rows(tcfg, tc, psi, q, tr, world):
    """The port's plain rows versions on `world` shards, put together."""
    wrap = tcfg.sbc == -1
    n = N // world
    p_ext = halo.split_rows8(psi, world, wrap)
    q_ext = halo.split_rows8(q, world, wrap)
    t_ext = halo.split_rows8(tr.reshape(NL * 2, N, N), world, wrap)
    dqs, ums, dtrs = [], [], []
    for d in range(world):
        rows = slice(d * n, (d + 1) * n)
        dq, um = fused_rhs.rhs_fused(tcfg, tc, psi[:, rows],
                                     psi_ext=p_ext[d], q_ext=q_ext[d],
                                     row0=d * n)
        dtrs.append(fused_tracer.tracer_fused(
            tcfg, tc, psi[:, rows], tr[..., rows, :], psi_ext=p_ext[d],
            tr_ext=t_ext[d], row0=d * n))
        dqs.append(dq)
        ums.append(um)
    return (torch.cat(dqs, 1), torch.stack(ums).amax(0),
            torch.cat(dtrs, 2))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_rows_against_jax_rows_kernels(case):
    """K1's and K2's plain rows versions on 2 shards against the JAX
    rows-mode kernels (interpret mode) on the same shards."""
    sbc, kw = CASES[case]
    jcfg, tcfg = _configs(sbc, **kw)
    fields, psi, tr = _inputs(sbc)
    jc = jqg.build_constants(jcfg, **fields)
    jq = jqg.comp_q(jcfg, jc, jnp.asarray(psi))
    dq_j, um_j, dtr_j = _jax_rows(jcfg, jc, jnp.asarray(psi), jq,
                                  jnp.asarray(tr))
    tc = tqg.build_constants(tcfg, device="cpu", **fields)
    tpsi, ttr = torch.as_tensor(psi), torch.as_tensor(tr)
    tq = torch.as_tensor(np.array(jq))
    dq, um, dtr = _port_rows(tcfg, tc, tpsi, tq, ttr, NDEV)
    assert np.abs(dq.numpy() - dq_j).max() <= 1e-12 * np.abs(dq_j).max()
    np.testing.assert_allclose(um.numpy(), um_j, rtol=1e-15, atol=0)
    assert np.abs(dtr.numpy() - dtr_j).max() <= 1e-12 * np.abs(dtr_j).max()


@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_rows_put_together_is_the_whole_domain(case, world):
    """The plain rows versions of 1-8 shards, put together, are the
    whole-domain plain versions bit for bit (the windows' wrong ghosts at
    shard edges stay outside the shard's rows)."""
    sbc, kw = CASES[case]
    _, tcfg = _configs(sbc, **kw)
    fields, psi, tr = _inputs(sbc)
    tc = tqg.build_constants(tcfg, device="cpu", **fields)
    tpsi, ttr = torch.as_tensor(psi), torch.as_tensor(tr)
    tq = tqg.comp_q(tcfg, tc, tpsi).contiguous()
    dq0, um0 = fused_rhs.rhs_fused(tcfg, tc, tpsi, tq)
    dtr0 = fused_tracer.tracer_fused(tcfg, tc, tpsi, ttr)
    dq, um, dtr = _port_rows(tcfg, tc, tpsi, tq, ttr, world)
    assert torch.equal(dq, dq0) and torch.equal(um, um0)
    assert torch.equal(dtr, dtr0)


def test_rows_mode_arguments_are_checked():
    """A row0 that puts the shard outside the domain, or tracers without
    tr_ext, are refused on any device."""
    _, tcfg = _configs(0.0)
    tc = tqg.build_constants(tcfg, device="cpu")
    psi = torch.zeros((NL, 16, N), dtype=torch.float64)
    ext = torch.zeros((NL, 32, N), dtype=torch.float64)
    with pytest.raises(ValueError, match="row0"):
        fused_rhs.rhs_fused(tcfg, tc, psi, psi_ext=ext, row0=N - 8)
    with pytest.raises(ValueError, match="tr_ext"):
        fused_tracer.tracer_fused(tcfg, tc, psi, psi[:, None],
                                  psi_ext=ext, row0=0)


def test_split_rows8_is_each_shards_halo_extension():
    """halo.split_rows8 (the virtual shards of the checks) is the shard
    with its neighbours' 8 rows either side, wrapped or zero at the walls
    (numpy's own rows)."""
    a = torch.as_tensor(np.random.default_rng(4).standard_normal((2, 48, 8)))
    for wrap in (False, True):
        for d, e in enumerate(halo.split_rows8(a, 3, wrap)):
            want = np.zeros((2, 32, 8))
            for k in range(32):
                r = d * 16 - 8 + k
                if wrap or 0 <= r < 48:
                    want[:, k] = a.numpy()[:, r % 48]
            assert e.is_contiguous() and np.array_equal(e.numpy(), want)


def _emulation():
    if shutil.which("g++") is None:
        pytest.skip("the host emulation needs g++")
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    import k1_emulation
    import strip_emulation
    return k1_emulation, strip_emulation


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The shipped K1 and K2 sources with their rows constant on (the rows
    libraries), built once for the module's tests."""
    k1, k2 = _emulation()
    out = tmp_path_factory.mktemp("emulation")
    return (k1, k1.load(k1.build("k1_rows", out=out, rows=True), rows=True),
            k2, k2.build("k2_rows", k2.ROWS, out=out))


@pytest.mark.parametrize("world,cases", [(2, [(48, 3)]), (4, [(64, 4)])])
def test_k1_rows_kernel_source_in_host_emulation(emulated, world, cases):
    """csrc/fused_rhs.cu's rows mode on virtual shards against the plain
    rows version, walled and periodic, f64 and f32: 2 shards of 24 rows (a
    partial strip) and 4 of 16, the uncoupled kernel, every coupling option
    at once and the stochastic variant."""
    k1, lib, _, _ = emulated
    errs = k1.errors(lib, cases, world=world,
                     names=("uncoupled", "all", "stochastic_all",
                            "energy_conserv_all"))
    assert max(errs.values()) <= 1.0, max(errs, key=errs.get)


def test_k2_rows_kernel_source_in_host_emulation(emulated):
    """csrc/fused_tracer.cu's rows mode on virtual shards against the plain
    rows version: 2 shards of 24 rows with 2 tracers (the template count)
    and 4 of 16 with 3 (the run-time loop), walled and periodic, f64 and
    f32."""
    _, _, k2, lib = emulated
    assert k2.rows_worst_error(lib) <= 1.0
