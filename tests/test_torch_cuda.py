"""The port on a CUDA card: the fused RHS kernel (K1) with and without its
coupling options, the fused tracer kernel (K2), the fused spectral solve
(K7), the multigrid's line sweep (K3) and residual (K4), and the qg-node
family's fused tendency (K5) and masked vertex sweep (K6) against their
plain PyTorch versions, the wrappers' input checks and launch counts, a
multigrid and a vertex-multigrid solve on the card against the CPU, and the
CUDA step against the CPU step, uncoupled, coupled, with the multigrid and
for the qg-node family; and the doubly periodic and stochastic modes: K1's
periodic (every option set) and stochastic (walled and periodic) modes,
K2's periodic mode, K7 on the periodic Fourier basis, and the periodic and
stochastic steps against the CPU; and the msqg driver (run_qg with the
wavelet filter, the energy budget and an OutputWriter) on the card
against the CPU, walled, coupled and periodic; and the qg-node driver
(run_node with the masked wavelet filter and a NodeOutput) on the card
against the CPU, walled, coastline-masked, periodic and stochastic at
amp_stoch = 0, and the card's node noise draw in distribution; and the
y-profile direct solve's sweeps (KV) against their plain version with the
wrapper's checks, the varRo step (spectral and mg), the newqg step and the
SQG step on the card against the CPU; and K1's and K2's rows mode on
virtual shards against the whole-domain launch; and the tendency API
(qg_tendency through K1 and K2 in both directions, bfn_integrate,
pg_tendency) on the card against the CPU; and the bf16 + refinement
solve's bf16 pass against its plain emulation and its float64 solve
against the CPU. Every test
needs a card
and nvcc, is marked
`cuda` and skips without a card. The file imports neither jax nor
msom_tpu, so it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: in f64 the kernel and the plain version differ only in the
order of a few sums (1e-11 of max|dq|); in f32 the biharmonic's stacked
Laplacians cancel, and 1e-4 of max|dq| is the bound that
tests/test_torch_rhs.py measures for that cancellation. K7 against the
cuBLAS chain: 1e-5 of max|psi_m| in f32 (two f32 roundings of N-term sums),
1e-12 in f64. K3 (after four sweeps) and K4: 1e-12 (f64) and 1e-5 (f32) of
max|out|; the kernels fuse a*b+c into one rounding and multiply by
1/delta^2 where the plain version divides. K5 as K1 (the same stacked
Laplacians), K6 (after four sweeps, or a relaxation of five) as K3; a
five-sweep relaxation equals five one-sweep launches bitwise. KV: 1e-11
(f64) and 1e-5 (f32) of max|psi| (the same sums, contracted). K7 in f32
runs a 3-pass TF32 split: its error against the f64 chain stays within 4
times the FP32 cuBLAS chain's."""

import dataclasses

import numpy as np
import pytest
import torch

from msom_tpu_torch.models import fused_rhs, fused_tracer
from msom_tpu_torch.models import qg
from msom_tpu_torch.models.qg_node import coastline_mask
from msom_tpu_torch.params import QGConfig
from msom_tpu_torch.solvers import fused_mg, fused_spectral, mg, spectral

from chip_smoke import (KV_SIZES, kv_problem, refine_pass_error,
                        refine_pass_ok)

pytestmark = pytest.mark.cuda

LIMITS = {torch.float32: 1e-4, torch.float64: 1e-11}
MG_LIMITS = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _config(N, nl, dtype, Re=0.0, **kw):
    return QGConfig(N=N, nl=nl, L0=80, Rom=0.025, Ekb=0.002, Eks=0.001,
                    tau0=1e-4, Re4=1563 * (N / 256) ** 3, Re=Re, beta=0.5,
                    Fr=(0.003,) * (nl - 1), dh=(1.0 / nl,) * nl, DT=5e-2,
                    tend=1e9, dtout=1e9, CFL=0.6, dtype=dtype,
                    solver="spectral", **kw).validate()


def _fields(cfg, seed, *names):
    """Rough numpy coupling fields: every stencil point matters."""
    rng = np.random.default_rng(seed)
    nl, N = cfg.nl, cfg.N
    shapes = dict(psipg=(nl, N, N), topo=(N, N), qforc=(nl, N, N),
                  ptr_relax=(nl, cfg.nptr, N, N))
    amp = dict(psipg=1e-3, topo=1e-2, qforc=1.0, ptr_relax=1e-3)
    return {n: amp[n] * rng.uniform(-1, 1, shapes[n]) for n in names}


def _psi(cfg, device, seed):
    rng = np.random.default_rng(seed)
    psi = 1e-3 * rng.uniform(-1, 1, (cfg.nl, cfg.N, cfg.N))
    return torch.as_tensor(psi, dtype=getattr(torch, cfg.dtype)).to(device)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("N,nl,Re", [(64, 1, 1000.0), (100, 3, 0.0),
                                     (128, 4, 1000.0), (48, 3, 1000.0),
                                     (257, 4, 0.0), (200, 8, 1000.0)])
def test_kernel_matches_plain_version(cuda, dtype, N, nl, Re):
    """A strip is 128 columns by 64 rows: N = 100 and 257 leave partial
    strips at the far walls (at 257 the last strip holds one row), N = 48
    puts all four walls into one strip; nl = 8 at N = 200 (16-byte
    copies, two strips across)."""
    cfg = _config(N, nl, dtype, Re)
    const = qg.build_constants(cfg, device=cuda)
    psi = _psi(cfg, cuda, N + nl)
    before = fused_rhs.launches
    dq, umax = fused_rhs.rhs_fused(cfg, const, psi)
    torch.cuda.synchronize()
    assert fused_rhs.launches == before + 1
    dq_r, umax_r = fused_rhs.rhs_fused_reference(cfg, const, psi)
    lim = LIMITS[psi.dtype]
    assert dq.shape == psi.shape and umax.shape == (nl,)
    assert (dq - dq_r).abs().max() <= lim * dq_r.abs().max()
    assert ((umax - umax_r).abs() <= lim * umax_r).all()


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    cfg = _config(64, 3, "float32")
    const = qg.build_constants(cfg, device=cuda)
    psi = _psi(cfg, cuda, 0)
    with pytest.raises(TypeError, match="dtype"):
        fused_rhs.rhs_fused(cfg, const, psi.half())
    with pytest.raises(ValueError, match="contiguous"):
        fused_rhs.rhs_fused(cfg, const, psi.transpose(1, 2))
    with pytest.raises(ValueError, match="const.wind"):
        fused_rhs.rhs_fused(cfg, const, psi.double())


def test_cuda_step_matches_cpu_step(cuda):
    """10 f64 steps of the Verron 64^2 x 3 deck from one numpy IC; each
    step launches the kernel twice."""
    cfg = QGConfig(N=64, nl=3, L0=80, Rom=0.025, Ekb=0.002, tau0=1e-4,
                   Re4=1563, beta=0.5, Fr=(0.0023669, 0.0076173),
                   dh=(0.06, 0.14, 0.8), DT=5e-2, tend=500., dtout=1.,
                   CFL=0.6, dtype="float64", solver="spectral").validate()
    psi0 = 1e-3 * np.random.default_rng(42).uniform(-1, 1, (3, 64, 64))
    step = qg.make_step(cfg)
    states = {}
    for dev in ("cpu", cuda):
        const = qg.build_constants(cfg, device=dev)
        state = qg.init_state(cfg, const, psi0=psi0)
        before = fused_rhs.launches
        for _ in range(10):
            state, diag = step(state, const, 1e9)
        states[str(dev)] = (state, fused_rhs.launches - before)
    (cpu, n_cpu), (gpu, n_gpu) = states["cpu"], states["cuda"]
    assert (n_cpu, n_gpu) == (0, 20)
    for name in ("q", "psi"):
        want = getattr(cpu, name)
        got = getattr(gpu, name).cpu()
        assert (got - want).abs().max() <= 1e-10 * want.abs().max(), name
    assert gpu.t.device.type == "cuda" and int(gpu.i) == 10


OPTIONS = {
    "pg": (dict(), ("psipg",)),
    "pg_flsrv": (dict(flsrv=1), ("psipg",)),
    "upg_vpg": (dict(upg=(0.02, 0.01, 0.0, 0.0), vpg=(0.01, 0.0, 0.0, 0.0),
                     flsrv=1), ()),
    "topo": (dict(), ("topo",)),
    "qforc": (dict(), ("qforc",)),
    "energy_conserv": (dict(energy_conserv=True), ()),
    "slip": (dict(sbc=1.0), ()),
    "all": (dict(flsrv=1, energy_conserv=True, sbc=0.5),
            ("psipg", "topo", "qforc")),
}


# nl = 8 in f32 only: in f64 the rings of pp (and of q) need more shared
# memory than a block may use at nl = 8 (see the refusal test below)
COUPLED_SIZES = [(dtype, N, nl) for dtype in ("float64", "float32")
                 for N, nl in ((64, 1), (100, 3), (128, 4), (48, 3),
                               (257, 4))] + [("float32", 200, 8)]


@pytest.mark.parametrize("dtype,N,nl", COUPLED_SIZES)
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_coupled_kernel_matches_plain_version(cuda, dtype, N, nl, option):
    kw, names = OPTIONS[option]
    cfg = _config(N, nl, dtype, 1000.0, **kw)
    const = qg.build_constants(cfg, device=cuda, **_fields(cfg, N, *names))
    psi = _psi(cfg, cuda, N + nl)
    q = qg.comp_q(cfg, const, psi) if cfg.energy_conserv else None
    before = fused_rhs.launches
    dq, umax = fused_rhs.rhs_fused(cfg, const, psi, q)
    torch.cuda.synchronize()
    assert fused_rhs.launches == before + 1
    dq_r, umax_r = fused_rhs.rhs_fused_reference(cfg, const, psi, q)
    lim = LIMITS[psi.dtype]
    assert (dq - dq_r).abs().max() <= lim * dq_r.abs().max()
    assert ((umax - umax_r).abs() <= lim * umax_r).all()
    if nl > 1 or option in ("topo", "qforc", "slip", "all"):
        bare = _config(N, nl, dtype, 1000.0)
        dq_b, _ = fused_rhs.rhs_fused(
            bare, qg.build_constants(bare, device=cuda), psi)
        assert not torch.equal(dq, dq_b)      # the option did something


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("relax", [False, True])
@pytest.mark.parametrize("N,nl,nptr", [(64, 1, 1), (100, 3, 2), (128, 4, 3),
                                       (48, 3, 2), (257, 4, 2), (130, 2, 2),
                                       (64, 2, 5), (96, 1, 16)])
def test_tracer_kernel_matches_plain_version(cuda, dtype, relax, N, nl, nptr):
    """Distinct Pe and relaxation times per tracer: a wrong (l, j) order of
    the flattened planes would show. N = 48: one strip holds all four walls;
    N = 257: the last strips are one column and one row, and the rows are
    copied one element at a time; nptr = 5 and 16: the loop over a run-time
    nptr."""
    Pe = ((1e3, 2e3, 7e2) + tuple(1e3 + 90.0 * j for j in range(3, nptr)))
    ptr_r = ((100.0, 0.0, 13.0) + tuple(5.0 + j for j in range(3, nptr)))
    Pe, ptr_r = Pe[:nptr], ptr_r[:nptr]
    cfg = _config(N, nl, dtype, nptr=nptr, Pe=Pe, ptr_r=ptr_r)
    const = qg.build_constants(
        cfg, device=cuda, **_fields(cfg, N, *(["ptr_relax"] if relax else [])))
    psi = _psi(cfg, cuda, N)
    tr = torch.as_tensor(
        np.random.default_rng(nptr).uniform(-1, 1, (nl, nptr, N, N)),
        dtype=psi.dtype).to(cuda)
    before = fused_tracer.launches
    dtr = fused_tracer.tracer_fused(cfg, const, psi, tr)
    torch.cuda.synchronize()
    assert fused_tracer.launches == before + 1
    dtr_r = fused_tracer.tracer_fused_reference(cfg, const, psi, tr)
    assert dtr.shape == tr.shape
    assert (dtr - dtr_r).abs().max() <= LIMITS[psi.dtype] * dtr_r.abs().max()


@pytest.mark.parametrize("rows", [1, 7, 64])
@pytest.mark.parametrize("nptr", [2, 3])
def test_tracer_kernel_takes_the_callers_strip_height(cuda, monkeypatch, rows,
                                                      nptr):
    """The wrapper's launch_geometry decides the strips: any height gives
    the plain version's values (rows = 1: a strip of one row, shorter than
    the copies' lead), in both the template and the run-time case."""
    monkeypatch.setattr(fused_tracer, "SY", rows)
    cfg = _config(130, 2, "float64", nptr=nptr, Pe=(1e3, 2e3, 7e2)[:nptr],
                  ptr_r=(100.0, 0.0, 13.0)[:nptr])
    const = qg.build_constants(cfg, device=cuda,
                               **_fields(cfg, rows, "ptr_relax"))
    psi = _psi(cfg, cuda, rows)
    tr = torch.as_tensor(
        np.random.default_rng(rows).uniform(-1, 1, (2, nptr, 130, 130)),
        dtype=psi.dtype).to(cuda)
    dtr = fused_tracer.tracer_fused(cfg, const, psi, tr)
    dtr_r = fused_tracer.tracer_fused_reference(cfg, const, psi, tr)
    assert (dtr - dtr_r).abs().max() <= LIMITS[psi.dtype] * dtr_r.abs().max()


@pytest.mark.parametrize("name,value", [("RING", 5), ("TX", 256)])
def test_tracer_launch_refuses_a_geometry_that_does_not_fit(cuda, monkeypatch,
                                                            name, value):
    """A ring short of the kernel's rows, or a grid of the wrong strip
    width, is refused at the launch, not run."""
    monkeypatch.setattr(fused_tracer, name, value)
    cfg = _config(256, 1, "float32", nptr=2, Pe=(1e3, 2e3),
                  ptr_r=(100.0, 0.0))
    const = qg.build_constants(cfg, device=cuda)
    psi = _psi(cfg, cuda, 0)
    tr = torch.zeros((1, 2, 256, 256), device=cuda)
    before = fused_tracer.launches
    with pytest.raises(RuntimeError, match="fused_tracer launch failed"):
        fused_tracer.tracer_fused(cfg, const, psi, tr)
    assert fused_tracer.launches == before


@pytest.mark.parametrize("dtype,limit", [("float64", 1e-12),
                                         ("float32", 1e-5)])
@pytest.mark.parametrize("N,nl", [(128, 1), (256, 3), (512, 4), (1024, 2)])
def test_spectral_kernel_matches_cublas_chain(cuda, dtype, limit, N, nl):
    spec = spectral.build_spectral(
        nl=nl, N=N, L0=80.0, dh=np.full(nl, 1.0 / nl),
        s_profile=np.full(nl - 1, 0.0144), dtype=getattr(torch, dtype),
        transform="matmul", fused_mm=True, device=cuda)
    qm = torch.as_tensor(np.random.default_rng(N).standard_normal((nl, N, N)),
                         dtype=getattr(torch, dtype)).to(cuda)
    before = fused_spectral.launches
    pm = fused_spectral.fused_mm_solve(spec.S, spec.inv_den, qm, spec.mm)
    torch.cuda.synchronize()
    assert fused_spectral.launches == before + 4
    pm_r = spectral._mm_solve(spec.S, spec.inv_den, qm)
    assert (pm - pm_r).abs().max() <= limit * pm_r.abs().max()
    # the solve goes through the kernel when the data says fused_mm
    q = torch.einsum("lm,myx->lyx", spec.m2l, qm) if nl > 1 else qm
    before = fused_spectral.launches
    spectral.solve_spectral(spec, q)
    assert fused_spectral.launches == before + 4


@pytest.mark.parametrize("N,nl", [(128, 1), (512, 4), (1024, 4)])
def test_spectral_kernel_error_is_the_fp32_chains(cuda, N, nl):
    """K7 in float32 (3-pass TF32 on the tensor cores) against the float64
    chain on the same inputs: within 4 times the FP32 cuBLAS chain's own
    error, and within 1e-5 of max|psi_m|."""
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = spectral.build_spectral(
        nl=nl, N=N, L0=80.0, dh=np.full(nl, 1.0 / nl),
        s_profile=np.full(nl - 1, 0.0144), dtype=torch.float32,
        transform="matmul", fused_mm=True, device=cuda)
    assert spec.mm is not None
    qm = torch.as_tensor(np.random.default_rng(N + 1).standard_normal(
        (nl, N, N)), dtype=torch.float32).to(cuda)
    pm = fused_spectral.fused_mm_solve(spec.S, spec.inv_den, qm, spec.mm)
    fp32 = spectral._mm_solve(spec.S, spec.inv_den, qm)
    want = spectral._mm_solve(spec.S.double(), spec.inv_den.double(),
                              qm.double())
    scale = want.abs().max()
    err = (pm.double() - want).abs().max() / scale
    err32 = (fp32.double() - want).abs().max() / scale
    assert err <= 1e-5 and err <= 4 * err32, (float(err), float(err32))


@pytest.mark.parametrize("N,nl", [(128, 1), (512, 4), (2048, 4)])
def test_refine_bf16_pass_and_float64_solve_on_the_card(cuda, N, nl):
    """The refine solve's bf16 pass on a float32 tensor (bf16 operands,
    float32 accumulation and outputs) against its plain emulation, as
    chip_smoke's refine_pass_ok holds it (relative RMS, and closer to it
    than to the full-float32 chain); and the float64 refine
    solve, walled and periodic, on the card against the CPU within 1e-10
    of max|psi|."""
    kw = dict(nl=nl, N=N, L0=80.0, dh=np.full(nl, 1.0 / nl),
              s_profile=np.full(nl - 1, 0.0144), transform="matmul",
              refine=True)
    spec = spectral.build_spectral(dtype=torch.float32, device=cuda, **kw)
    assert spec.Sb.dtype == torch.bfloat16 and spec.fac is None
    rng = np.random.default_rng(N)
    qm = torch.as_tensor(rng.standard_normal((nl, N, N)),
                         dtype=torch.float32).to(cuda)
    rms, _, rms_f32 = refine_pass_error(spec, qm)
    assert refine_pass_ok(rms, rms_f32), (rms, rms_f32)
    if N > 512:
        return
    q = torch.as_tensor(rng.standard_normal((nl, N, N)))
    for periodic in (False, True):
        kw["periodic"] = periodic
        want = spectral.solve_spectral(spectral.build_spectral(
            dtype=torch.float64, device="cpu", **kw), q)
        got = spectral.solve_spectral(spectral.build_spectral(
            dtype=torch.float64, device=cuda, **kw), q.to(cuda)).cpu()
        err = (got - want).abs().max() / want.abs().max()
        assert err <= 1e-10, (periodic, float(err))


def test_coupled_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    cfg = _config(64, 3, "float32", nptr=2, Pe=(1e3, 2e3), ptr_r=(100., 0.))
    const = qg.build_constants(cfg, device=cuda,
                               **_fields(cfg, 0, "psipg", "topo"))
    psi = _psi(cfg, cuda, 0)
    tr = torch.zeros((3, 2, 64, 64), device=cuda)
    # K1: a coupling field of another type, or not contiguous
    bad = dataclasses.replace(const, pp=const.pp.double())
    with pytest.raises(ValueError, match="const.pp"):
        fused_rhs.rhs_fused(cfg, bad, psi)
    bad = dataclasses.replace(const, topo=const.topo.t())
    with pytest.raises(ValueError, match="const.topo"):
        fused_rhs.rhs_fused(cfg, bad, psi)
    ec = dataclasses.replace(cfg, energy_conserv=True)
    with pytest.raises(ValueError, match="needs q"):
        fused_rhs.rhs_fused(ec, const, psi)
    # K2: wrong type, wrong shape, not contiguous
    with pytest.raises(TypeError, match="dtype"):
        fused_tracer.tracer_fused(cfg, const, psi.half(), tr.half())
    with pytest.raises(ValueError, match="tracers"):
        fused_tracer.tracer_fused(cfg, const, psi, tr[:, :1])
    with pytest.raises(ValueError, match="tracers"):
        fused_tracer.tracer_fused(cfg, const, psi, tr.transpose(2, 3))
    # K7: N outside the gate, wrong type, not contiguous
    S = torch.zeros((64, 64), device=cuda)
    with pytest.raises(ValueError, match="N = 64"):
        fused_spectral.fused_mm_solve(S, S[None], S[None])
    S = torch.eye(128, device=cuda)
    D = torch.ones((2, 128, 128), device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        fused_spectral.fused_mm_solve(S.half(), D.half(), D.half())
    with pytest.raises(ValueError, match="qm"):
        fused_spectral.fused_mm_solve(S, D, D.transpose(1, 2))
    with pytest.raises(ValueError, match="inv_den"):
        fused_spectral.fused_mm_solve(S, D.double(), D)
    with pytest.raises(ValueError, match="needs mm"):
        fused_spectral.fused_mm_solve(S, D, D)


def test_option_set_that_exceeds_shared_memory_is_refused(cuda):
    """All layers of a strip's ring rows are held at once: pp + _LS_RV at
    nl = 7 in f64 needs more than the 227 KB a block may use (nl = 6
    fits), where the uncoupled kernel still runs."""
    cfg = _config(64, 7, "float64", flsrv=1)
    psi = _psi(cfg, cuda, 1)
    const = qg.build_constants(cfg, device=cuda, **_fields(cfg, 1, "psipg"))
    with pytest.raises(ValueError, match="shared memory"):
        fused_rhs.rhs_fused(cfg, const, psi)
    bare = qg.build_constants(cfg, device=cuda)
    dq, _ = fused_rhs.rhs_fused(cfg, bare, psi)
    assert torch.isfinite(dq).all()


def test_coupled_cuda_step_matches_cpu_step(cuda):
    """10 f64 steps at 64^2 x 3 with pp, topography, forcing, two tracers,
    _LS_RV and partial slip; each step launches K1 and K2 twice."""
    cfg = QGConfig(N=64, nl=3, L0=80, Rom=0.025, Ekb=0.002, tau0=1e-4,
                   Re4=1563, beta=0.5, Fr=(0.0023669, 0.0076173),
                   dh=(0.06, 0.14, 0.8), DT=5e-2, tend=500., dtout=1.,
                   CFL=0.6, dtype="float64", solver="spectral", flsrv=1,
                   sbc=0.5, nptr=2, Pe=(1e3, 2e3),
                   ptr_r=(100.0, 0.0)).validate()
    rng = np.random.default_rng(42)
    psi0 = 1e-3 * rng.uniform(-1, 1, (3, 64, 64))
    tr0 = 1e-3 * rng.uniform(-1, 1, (3, 2, 64, 64))
    y = (np.arange(64) + 0.5) * cfg.delta
    gyre = np.sin(np.pi * y / cfg.L0)
    fields = dict(psipg=0.01 * gyre[None, :, None] * np.ones((3, 64, 64)),
                  topo=0.05 * np.outer(gyre, np.sin(2 * np.pi * y / cfg.L0)),
                  qforc=1e-5 * rng.standard_normal((3, 64, 64)))
    step = qg.make_step(cfg)
    states = {}
    for dev in ("cpu", cuda):
        const = qg.build_constants(cfg, device=dev, **fields)
        state = qg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
        before = fused_rhs.launches, fused_tracer.launches
        for _ in range(10):
            state, diag = step(state, const, 1e9)
        states[str(dev)] = (state, fused_rhs.launches - before[0],
                            fused_tracer.launches - before[1])
    (cpu, *n_cpu), (gpu, *n_gpu) = states["cpu"], states["cuda"]
    assert (n_cpu, n_gpu) == ([0, 0], [20, 20])
    for name in ("q", "psi", "tracers"):
        want = getattr(cpu, name)
        got = getattr(gpu, name).cpu()
        assert (got - want).abs().max() <= 1e-10 * want.abs().max(), name


def test_fused_mm_step_matches_matmul_step(cuda):
    """10 f32 steps at 128^2 x 3: the step whose inversion runs in K7
    against the same step on the cuBLAS chain."""
    psi0 = 1e-3 * np.random.default_rng(7).uniform(-1, 1, (3, 128, 128))
    finals = []
    for fused in (True, False):
        cfg = _config(128, 3, "float32", transform="matmul")
        const = qg.build_constants(cfg, device=cuda, fused_mm=fused)
        state = qg.init_state(cfg, const, psi0=psi0)
        step = qg.make_step(cfg)
        before = fused_spectral.launches
        for _ in range(10):
            state, _ = step(state, const, 1e9)
        assert fused_spectral.launches - before == (80 if fused else 0)
        finals.append(state.psi)
    assert torch.isfinite(finals[0]).all()
    assert (finals[0] - finals[1]).abs().max() \
        <= 1e-4 * finals[1].abs().max()


def _mg_level(nl, n, dtype, modal, device, seed=0):
    """One multigrid level with random y-profile coefficients, layered or
    in the modal shape, and two random fields."""
    rng = np.random.default_rng(seed)
    tdt = getattr(torch, dtype)
    s = lam = None
    idh0 = idh1 = np.zeros(nl)
    if modal:
        lam = torch.as_tensor(-rng.uniform(0.0, 5.0, (nl, n, 1)),
                              dtype=tdt).to(device)
    elif nl > 1:
        s = torch.as_tensor(rng.uniform(0.5, 2.0, (nl - 1, n, 1)),
                            dtype=tdt).to(device)
        idh0 = np.r_[0.0, rng.uniform(1, 3, nl - 1)]
        idh1 = np.r_[rng.uniform(1, 3, nl - 1), 0.0]
    lvl = mg._build_level(nl, n, 80.0 / n, s, lam, idh0, idh1, tdt,
                          torch.device(device))
    a = torch.as_tensor(rng.standard_normal((nl, n, n)), dtype=tdt).to(device)
    b = torch.as_tensor(rng.standard_normal((nl, n, n)), dtype=tdt).to(device)
    return lvl, a, b, idh0, idh1


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("modal", [False, True])
@pytest.mark.parametrize("signs", [(-1.0, -1.0), (1.0, 1.0), (1.0, -1.0)])
@pytest.mark.parametrize("n,nl", [(2, 3), (4, 1), (8, 4), (64, 2), (100, 3),
                                  (128, 4), (256, 8)])
def test_mg_kernels_match_plain_versions(cuda, dtype, modal, signs, n, nl):
    """Four sweeps in a row (a fault on a tile's rim would spread) and one
    residual; n = 100 leaves partial tiles, n <= 8 one partial tile."""
    lvl, da, res, idh0, idh1 = _mg_level(nl, n, dtype, modal, cuda, n + nl)
    sx, sy = signs
    lim = MG_LIMITS[da.dtype]
    kw = dict(d2=lvl.delta ** 2, sign_x=sx, sign_y=sy)
    before = fused_mg.sweep_launches, fused_mg.residual_launches
    k = p = da
    for _ in range(4):
        k = fused_mg.rb_line_sweep(k, res, lvl.sw, **kw)
        p = fused_mg.rb_line_sweep_reference(p, res, lvl.sw, **kw)
    kw = dict(delta=lvl.delta, idh0=idh0, idh1=idh1, sign_x=sx, sign_y=sy)
    r_k, m_k = fused_mg.residual_norm(da, res, lvl.rp, **kw)
    torch.cuda.synchronize()
    assert (fused_mg.sweep_launches - before[0],
            fused_mg.residual_launches - before[1]) == (4, 1)
    r_p, m_p = fused_mg.residual_norm_reference(da, res, lvl.rp, **kw)
    assert k.shape == da.shape and k.data_ptr() != da.data_ptr()
    assert (k - p).abs().max() <= lim * p.abs().max()
    assert (r_k - r_p).abs().max() <= lim * r_p.abs().max()
    assert m_k.ndim == 0 and abs(m_k - m_p) <= lim * m_p
    assert torch.equal(m_k, r_k.abs().max())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n,nl", [(2, 3), (16, 2), (32, 4), (64, 4),
                                  (100, 3), (128, 4), (130, 4), (256, 8),
                                  (257, 1)])
@pytest.mark.parametrize("nrelax", [1, 2, 4, 5, 9])
def test_mg_relax_is_one_sweep_launches_bit_for_bit(cuda, dtype, n, nl,
                                                    nrelax):
    """A relaxation launches ceil(nrelax / sweeps_per_launch) times and
    equals nrelax one-sweep launches bit for bit, and the plain version
    within MG_LIMITS; n = 100, 130, 257 leave partial strips, n <= 64 run
    whole in one block where they fit."""
    lvl, da, res, _, _ = _mg_level(nl, n, dtype, False, cuda, n * nl)
    kw = dict(d2=lvl.delta ** 2, sign_x=-1.0, sign_y=-1.0)
    most = fused_mg.sweeps_per_launch(n, nl, da.dtype)
    before = fused_mg.sweep_launches, fused_mg.sweeps
    k = fused_mg.relax(da, res, lvl.sw, nrelax=nrelax, **kw)
    assert (fused_mg.sweep_launches - before[0],
            fused_mg.sweeps - before[1]) == (-(-nrelax // most), nrelax)
    one = da
    for _ in range(nrelax):
        one = fused_mg.rb_line_sweep(one, res, lvl.sw, **kw)
    p = fused_mg.relax_reference(da, res, lvl.sw, nrelax=nrelax, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k, one)
    assert (k - p).abs().max() <= MG_LIMITS[da.dtype] * p.abs().max()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n,nl", [(64, 3), (256, 2), (66, 1), (8, 2)])
def test_mg_kernels_periodic_x_match_plain_versions(cuda, dtype, n, nl):
    """periodic_x: x wraps, the ghost rows are rows 7 and n - 8 (in a sweep
    as they were before it); one sweep a launch."""
    lvl, da, res, idh0, idh1 = _mg_level(nl, n, dtype, False, cuda, n)
    lim = MG_LIMITS[da.dtype]
    kw = dict(d2=lvl.delta ** 2, sign_x=-1.0, sign_y=-1.0, periodic_x=True)
    before = fused_mg.sweep_launches
    k = fused_mg.relax(da, res, lvl.sw, nrelax=3, **kw)
    assert fused_mg.sweep_launches - before == 3
    p = fused_mg.relax_reference(da, res, lvl.sw, nrelax=3, **kw)
    assert (k - p).abs().max() <= lim * p.abs().max()
    rkw = dict(delta=lvl.delta, idh0=idh0, idh1=idh1, sign_x=-1.0,
               sign_y=-1.0, periodic_x=True)
    r_k, m_k = fused_mg.residual_norm(da, res, lvl.rp, **rkw)
    r_p, m_p = fused_mg.residual_norm_reference(da, res, lvl.rp, **rkw)
    assert (r_k - r_p).abs().max() <= lim * r_p.abs().max()
    assert abs(m_k - m_p) <= lim * m_p
    with pytest.raises(ValueError, match="even n >= 8"):
        fused_mg.relax(da[:, :6, :6].contiguous(), res[:, :6, :6]
                       .contiguous(), _mg_level(nl, 6, dtype, False, cuda)[0]
                       .sw, nrelax=1, **kw)


def test_mg_residual_norm_carries_a_nan(cuda):
    lvl, a, b, idh0, idh1 = _mg_level(3, 100, "float32", False, cuda)
    a[2, 99, 0] = float("nan")
    _, m = fused_mg.residual_norm(a, b, lvl.rp, delta=lvl.delta, idh0=idh0,
                                  idh1=idh1, sign_x=-1.0, sign_y=-1.0)
    assert torch.isnan(m)


def test_mg_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    lvl, a, b, idh0, idh1 = _mg_level(3, 64, "float32", False, cuda)
    skw = dict(d2=1.0, sign_x=-1.0, sign_y=-1.0)
    rkw = dict(delta=1.0, idh0=idh0, idh1=idh1, sign_x=-1.0, sign_y=-1.0)
    with pytest.raises(TypeError, match="dtype"):
        fused_mg.rb_line_sweep(a.half(), b.half(), lvl.sw, **skw)
    with pytest.raises(ValueError, match="res"):
        fused_mg.rb_line_sweep(a, b.transpose(1, 2), lvl.sw, **skw)
    with pytest.raises(ValueError, match="prof.t0"):
        fused_mg.rb_line_sweep(a.double(), b.double(), lvl.sw, **skw)
    with pytest.raises(ValueError, match=r"\(nl, n, n\)"):
        fused_mg.rb_line_sweep(a[:, :32], b[:, :32], lvl.sw, **skw)
    with pytest.raises(ValueError, match="b must"):
        fused_mg.residual_norm(a, b.double(), lvl.rp, **rkw)
    with pytest.raises(ValueError, match="prof.s"):
        fused_mg.residual_norm(a[:2].contiguous(), b[:2].contiguous(),
                               lvl.rp, **{**rkw, "idh0": idh0[:2],
                                          "idh1": idh1[:2]})
    with pytest.raises(ValueError, match="idh0"):
        fused_mg.residual_norm(a, b, lvl.rp, **{**rkw, "idh0": idh0[:2]})
    big, a9, b9, i0, i1 = _mg_level(9, 16, "float32", True, cuda)
    with pytest.raises(ValueError, match="nl = 9"):
        fused_mg.rb_line_sweep(a9, b9, big.sw, **skw)
    with pytest.raises(ValueError, match="nl = 9"):
        fused_mg.residual_norm(a9, b9, big.rp, **{**rkw, "idh0": i0,
                                                  "idh1": i1})


@pytest.mark.parametrize("case", ["layered", "modal", "xvary", "periodic"])
def test_mg_solve_on_the_card_matches_the_cpu(cuda, case):
    """f64, 64^2 x 3, tol 1e-8: the same cycles and nrelax, the solution to
    1e-10. Levels with profiles and wall BCs run the kernels on the card;
    x-varying coefficients and a periodic solve run torch ops on both."""
    rng = np.random.default_rng(5)
    nl, n = 3, 64
    kw = dict(L0=80.0, tolerance=1e-8,
              bc=qg.BC.PERIODIC if case == "periodic" else qg.BC.DIRICHLET)
    coef = {}
    if case in ("modal", "periodic"):
        coef["lam"] = torch.tensor(-rng.uniform(0.5, 5.0, (nl, n, 1)))
    else:
        coef["s"] = torch.tensor(rng.uniform(0.5, 2.0, (nl - 1, n, 1)))
        if case == "xvary":
            coef["s"] = coef["s"] * torch.tensor(
                rng.uniform(0.9, 1.1, (nl - 1, n, n)))
        kw["idh0"] = np.r_[0.0, rng.uniform(1, 3, nl - 1)]
        kw["idh1"] = np.r_[rng.uniform(1, 3, nl - 1), 0.0]
    b = torch.tensor(rng.standard_normal((nl, n, n)))
    out = {}
    for dev in ("cpu", cuda):
        before = (fused_mg.sweep_launches, fused_mg.residual_launches,
                  fused_mg.sweeps)
        a, st = mg.solve_layered(
            torch.zeros_like(b).to(dev), b.to(dev),
            **{k: v.to(dev) for k, v in coef.items()}, **kw)
        out[str(dev)] = (a.cpu(), st, fused_mg.sweep_launches - before[0],
                         fused_mg.residual_launches - before[1],
                         fused_mg.sweeps - before[2])
    (a_c, st_c, *n_c), (a_g, st_g, *n_g) = out["cpu"], out["cuda"]
    assert (st_g.iters, st_g.nrelax) == (st_c.iters, st_c.nrelax)
    assert st_g.resa <= 1e-8 and st_g.iters > 1
    assert (a_g - a_c).abs().max() <= 1e-10 * a_c.abs().max()
    assert n_c == [0, 0, 0]
    if case in ("layered", "modal"):
        # a relaxation of nrelax >= 2 sweeps a level a cycle, one launch
        # each on these levels (every one whole in one block)
        assert n_g[1] == st_g.iters + 1 and n_g[0] == 6 * st_g.iters
        assert n_g[2] >= 6 * 2 * st_g.iters
    else:
        assert n_g == [0, 0, 0]


@pytest.mark.parametrize("modal", [False, True])
@pytest.mark.parametrize("extrap", [True, False])
def test_mg_cuda_step_matches_cpu_step(cuda, modal, extrap):
    """10 f64 steps of the Verron 64^2 x 3 deck with solver="mg": the same
    V-cycles every step, and on the card every sweep and residual is a
    kernel launch."""
    cfg = QGConfig(N=64, nl=3, L0=80, Rom=0.025, Ekb=0.002, tau0=1e-4,
                   Re4=1563, beta=0.5, Fr=(0.0023669, 0.0076173),
                   dh=(0.06, 0.14, 0.8), DT=5e-2, tend=500., dtout=1.,
                   CFL=0.6, dtype="float64", solver="mg", mg_extrap=extrap,
                   mode_pv_invert=modal).validate()
    psi0 = 1e-3 * np.random.default_rng(42).uniform(-1, 1, (3, 64, 64))
    step = qg.make_step(cfg)
    runs = {}
    for dev in ("cpu", cuda):
        const = qg.build_constants(cfg, device=dev)
        state = qg.init_state(cfg, const, psi0=psi0)
        before = (fused_rhs.launches, fused_mg.sweep_launches,
                  fused_mg.residual_launches)
        cycles = []
        for _ in range(10):
            state, diag = step(state, const, 1e9)
            cycles.append(diag.mg_iters)
        runs[str(dev)] = (state, cycles, fused_rhs.launches - before[0],
                          fused_mg.sweep_launches - before[1],
                          fused_mg.residual_launches - before[2])
    (cpu, c_cpu, *n_cpu), (gpu, c_gpu, *n_gpu) = runs["cpu"], runs["cuda"]
    assert c_gpu == c_cpu and min(c_gpu) >= 1
    assert n_cpu == [0, 0, 0]
    assert n_gpu[0] == 20 and n_gpu[1] > 0
    # a solve: one K4 for its first residual and one a cycle; the second
    # solve of a step takes at least one cycle
    assert n_gpu[2] >= 20 + sum(c_gpu) + 10
    for name in ("q", "psi") + (("psi_old",) if extrap else ()):
        want = getattr(cpu, name)
        got = getattr(gpu, name).cpu()
        assert (got - want).abs().max() <= 1e-10 * want.abs().max(), name
    assert (gpu.psi_old is None) == (not extrap)


# ---------------------------------------------------------------------------
# the qg-node family: K5 (fused nodal tendency) and K6 (masked vertex sweep)
# ---------------------------------------------------------------------------

def _node_config(N, nl, dtype, **kw):
    from msom_tpu_torch.models import qg_node
    base = dict(N=N, nl=nl, L0=100.0, f0=46.5, beta=0.5, hEkb=1e-3,
                tau0=1e-3, tau1=5e-4, tf1=2.0, tf2=3.0, dy_ws=0.3, nu=5.0,
                dh=tuple([1.0 / nl] * nl), N2=tuple([1.0 + l for l in
                                                     range(nl - 1)]),
                noise_init=1e-3, bc_fac=0.0, DT=5e-2, CFL=0.2,
                TOLERANCE=1e-8, dtype=dtype)
    base.update(kw)
    return qg_node.NodeQGConfig(**base)


NODE_OPTIONS = {
    "freeslip": {},
    "noslip_nu4": dict(bc_fac=1.0, nu4=50.0),
    "pg": dict(inputs=("psi_pg",)),
    "topo": dict(inputs=("topo",)),
    "qf3": dict(inputs=("q_forcing_3d",)),
    "flag_ms": dict(flag_ms=1),
    "island": dict(inputs=("island",)),
    "all": dict(bc_fac=1.0, nu4=50.0, flag_ms=1,
                inputs=("psi_pg", "topo", "q_forcing_3d", "island")),
}


def _node_case(N, nl, dtype, option, device, seed=0):
    """(cfg, const, q, psi) of one K5 option set with rough fields. The
    constants are built without flag_ms and the island (either would select
    the vertex multigrid, which needs N a power of 2) and take them after:
    K5 reads only the mask and the S2 profile."""
    from msom_tpu_torch.models import qg_node
    from msom_tpu_torch.ops import vertex
    kw = dict(NODE_OPTIONS.get(option, dict(gp_low=4.0)))
    names = kw.pop("inputs", ())
    cfg = _node_config(N, nl, dtype, **kw)
    rng = np.random.default_rng(seed)
    M = N + 1
    inputs = {}
    if "psi_pg" in names:
        inputs["psi_pg"] = 1e-3 * rng.uniform(-1, 1, (nl, M, M))
    if "topo" in names:
        inputs["topo"] = 1e-2 * rng.uniform(-1, 1, (M, M))
    if "q_forcing_3d" in names:
        inputs["q_forcing_3d"] = rng.uniform(-1, 1, (nl, M, M))
    const = qg_node.build_constants(dataclasses.replace(cfg, flag_ms=0),
                                    device=device, **inputs)
    tdt = getattr(torch, dtype)
    if cfg.flag_ms:
        # S2 = f_var^2 / N2, f_var = f0 + beta (y - L0/2)
        f_var = cfg.f0 + cfg.beta * (np.arange(M) * cfg.delta - cfg.L0 / 2)
        prof = torch.as_tensor(f_var[None] ** 2
                               / np.asarray(cfg.N2)[:, None],
                               dtype=tdt).to(device)
        const = dataclasses.replace(
            const, S2_prof=prof,
            S2=prof[..., None].expand(nl - 1, M, M).contiguous())
    if "island" in names:
        m = const.mask.clone()
        m[M // 3:M // 3 + 6, M // 2:M // 2 + 7] = 0.0
        const = dataclasses.replace(const, mask=m)
    psi = torch.as_tensor(1e-3 * rng.uniform(-1, 1, (nl, M, M)),
                          dtype=tdt).to(device)
    psi = vertex.bc_psi(psi)
    return cfg, const, qg_node.comp_q(cfg, const, psi), psi


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("N,nl,option", [(64, 1, "barotropic")] + [
    (N, nl, option)
    for N, nl in ((100, 3), (128, 4), (24, 4), (256, 4), (200, 8))
    for option in sorted(NODE_OPTIONS)])
def test_node_kernel_matches_plain_version(cuda, dtype, N, nl, option):
    """K5 against its plain version with each option set at the strips'
    edges: N = 24 (one strip holds all four walls), N = 100 and 200 (partial
    last strips), N = 128 and 256 (M = 2^k + 1: the last strip keeps one
    more column and row, the wall's); nl = 3 and 8 run the loop over a
    run-time nl, nl = 4 the unrolled case; nl = 1 is the barotropic form."""
    from msom_tpu_torch.models import fused_node_rhs, qg_node
    cfg, const, q, psi = _node_case(N, nl, dtype, option, cuda, N + nl)
    qf = qg_node.q_forcing_profile(cfg, const.yv[:, 0],
                                   torch.tensor(0.37, device=cuda,
                                                dtype=psi.dtype))
    before = fused_node_rhs.launches
    dq = fused_node_rhs.rhs_fused_node(cfg, const, q, psi, qf)
    torch.cuda.synchronize()
    assert fused_node_rhs.launches == before + 1
    ref = fused_node_rhs.rhs_node_reference(cfg, const, q, psi, qf)
    assert (dq - ref).abs().max() <= LIMITS[psi.dtype] * ref.abs().max()


def test_node_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from msom_tpu_torch.models import fused_node_rhs, qg_node
    cfg, const, q, psi = _node_case(32, 3, "float32", "freeslip", cuda)
    qf = torch.zeros(33, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        fused_node_rhs.rhs_fused_node(cfg, const, q, psi.half(), qf)
    with pytest.raises(ValueError, match="qf_profile"):
        fused_node_rhs.rhs_fused_node(cfg, const, q, psi, qf.double())
    with pytest.raises(ValueError, match="psi must"):
        fused_node_rhs.rhs_fused_node(cfg, const, q, psi.transpose(1, 2),
                                      qf)
    # an x-varying S2 has no profile: the kernel refuses, rhs_pv runs the
    # torch ops on the card
    N2 = 1.0 + np.random.default_rng(0).uniform(0, 1, (2, 33, 33))
    xconst = qg_node.build_constants(cfg, N2=N2, device=cuda)
    with pytest.raises(ValueError, match="varies in x"):
        fused_node_rhs.rhs_fused_node(cfg, xconst, q, psi, qf)
    before = fused_node_rhs.launches
    t = torch.zeros((), device=cuda)
    dq = qg_node.rhs_pv(cfg, xconst, q, psi, t)
    assert fused_node_rhs.launches == before and dq.is_cuda
    # every nl <= 8 fits in a block's shared memory, in f64 with every
    # field too; nl = 9 is past the kernel's layers
    big, bconst, bq, bpsi = _node_case(16, 9, "float64", "freeslip", cuda)
    with pytest.raises(ValueError, match="kernel takes 1 to 8"):
        fused_node_rhs.rhs_fused_node(big, bconst, bq, bpsi,
                                      torch.zeros(17, device=cuda,
                                                  dtype=torch.float64))


def _vlevel(nl, n, dtype, device, seed=0):
    """The finest vertex level of a coastline-masked grid with an
    x-varying S2, and two random masked fields."""
    from msom_tpu_torch.solvers import vmg
    rng = np.random.default_rng(seed)
    N = n - 1
    tdt = getattr(torch, dtype)
    mask = torch.as_tensor(coastline_mask(N), dtype=tdt).to(device)
    S2 = None
    if nl > 1:
        S2 = torch.as_tensor(1.0 + 0.3 * rng.standard_normal(
            (nl - 1, n, n)) ** 2, dtype=tdt).to(device)
    idh0 = np.r_[0.0, rng.uniform(1, 3, nl - 1)]
    idh1 = np.r_[rng.uniform(1, 3, nl - 1), 0.0]
    lvl = vmg.build_vlevels(nl=nl, N=N, L0=100.0, S2=S2, idh0=idh0,
                            idh1=idh1, mask=mask, dtype=tdt,
                            iRd2_low=0.0 if nl > 1 else 5.0)[0]
    da, res = (torch.as_tensor(rng.standard_normal((nl, n, n)), dtype=tdt)
               .to(device) * mask for _ in range(2))
    return lvl, da, res


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n,nl", [(3, 1), (5, 2), (9, 3), (17, 4), (65, 3),
                                  (129, 4), (257, 8)])
def test_vmg_sweep_matches_plain_version(cuda, dtype, n, nl):
    """Four K6 sweeps in a row against four plain ones; every n is 2^k + 1,
    so the last tile is partial."""
    from msom_tpu_torch.solvers import fused_vmg
    lvl, da, res = _vlevel(nl, n, dtype, cuda, n + nl)
    before = fused_vmg.launches
    k = p = da
    for _ in range(4):
        k = fused_vmg.vrb_sweep(k, res, lvl)
        p = fused_vmg.vrb_sweep_reference(p, res, lvl)
    torch.cuda.synchronize()
    assert fused_vmg.launches == before + 4
    assert k.shape == da.shape and k.data_ptr() != da.data_ptr()
    assert (k - p).abs().max() <= MG_LIMITS[da.dtype] * p.abs().max()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("nl", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n", [3, 5, 17, 33, 65, 257, 2049])
def test_vmg_relax_is_five_single_sweeps(cuda, dtype, n, nl):
    """One launch of vrb_relax(..., NRELAX) against NRELAX one-sweep
    launches (bitwise: each node's update reads the same inputs in the same
    order, the contractions spelled out) and against the plain version."""
    from msom_tpu_torch.solvers import fused_vmg, vmg
    lvl, da, res = _vlevel(nl, n, dtype, cuda, 3 * n + nl)
    before = fused_vmg.launches
    got = fused_vmg.vrb_relax(da, res, lvl, vmg.NRELAX)
    torch.cuda.synchronize()
    assert fused_vmg.launches == before + 1
    k = da
    for _ in range(vmg.NRELAX):
        k = fused_vmg.vrb_sweep(k, res, lvl)
    assert fused_vmg.launches == before + 1 + vmg.NRELAX
    assert torch.equal(got, k)
    p = fused_vmg.vrb_relax_reference(da, res, lvl, vmg.NRELAX)
    assert (got - p).abs().max() <= MG_LIMITS[da.dtype] * p.abs().max()


def test_vmg_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from msom_tpu_torch.solvers import fused_vmg
    lvl, da, res = _vlevel(3, 33, "float32", cuda)
    with pytest.raises(TypeError, match="dtype"):
        fused_vmg.vrb_sweep(da.half(), res.half(), lvl)
    with pytest.raises(ValueError, match="res must"):
        fused_vmg.vrb_sweep(da, res.transpose(1, 2), lvl)
    with pytest.raises(ValueError, match="the level takes"):
        fused_vmg.vrb_sweep(da.double(), res.double(), lvl)
    with pytest.raises(ValueError, match="the mask"):
        fused_vmg.vrb_sweep(da, res,
                            dataclasses.replace(lvl, mask=lvl.mask[:, :32]))
    big, a9, r9 = _vlevel(9, 17, "float32", cuda)
    with pytest.raises(ValueError, match="nl = 9"):
        fused_vmg.vrb_sweep(a9, r9, big)
    with pytest.raises(ValueError, match="nsweep = 3"):
        fused_vmg.vrb_relax(da, res, lvl, 3)


def test_vpoisson_on_the_card_matches_the_cpu(cuda):
    """A masked solve, f64, 64^2 x 3, tol 1e-8: the same cycles, the
    solution to 1e-10, every relaxation one K6 launch on the card."""
    from msom_tpu_torch.solvers import fused_vmg, vmg
    rng = np.random.default_rng(5)
    nl, N = 3, 64
    S2 = torch.tensor(1.0 + 0.3 * rng.standard_normal((nl - 1, N + 1,
                                                       N + 1)) ** 2)
    mask = torch.tensor(coastline_mask(N))
    idh0 = np.r_[0.0, rng.uniform(1, 3, nl - 1)]
    idh1 = np.r_[rng.uniform(1, 3, nl - 1), 0.0]
    b = torch.tensor(rng.standard_normal((nl, N + 1, N + 1))) * mask
    out = {}
    for dev in ("cpu", cuda):
        levels = vmg.build_vlevels(nl=nl, N=N, L0=100.0, S2=S2.to(dev),
                                   idh0=idh0, idh1=idh1, mask=mask.to(dev),
                                   dtype=torch.float64)
        before = fused_vmg.launches
        a, st = vmg.vpoisson(torch.zeros_like(b).to(dev), b.to(dev),
                             levels=levels, idh0=idh0, idh1=idh1,
                             tolerance=1e-8)
        out[str(dev)] = (a.cpu(), st, fused_vmg.launches - before)
    (a_c, st_c, n_c), (a_g, st_g, n_g) = out["cpu"], out["cuda"]
    assert st_g.iters == st_c.iters > 1 and st_g.resa <= 1e-8
    assert (a_g - a_c).abs().max() <= 1e-10 * a_c.abs().max()
    assert n_c == 0 and n_g == st_g.iters * len(levels)


@pytest.mark.parametrize("solver", ["auto", "vmg"])
def test_node_cuda_step_matches_cpu_step(cuda, solver):
    """10 f64 steps of the 3-layer no-slip deck at 64^2, with the spectral
    inversion, and with solver="vmg" and the coastline mask (the same
    V-cycles every step); every tendency a K5 launch on the card."""
    from msom_tpu_torch.models import fused_node_rhs, qg_node
    from msom_tpu_torch.solvers import fused_vmg
    cfg = _node_config(64, 3, "float64", bc_fac=1.0, solver=solver)
    inputs = dict(mask=coastline_mask(64)) if solver == "vmg" else {}
    psi0 = 1e-3 * np.random.default_rng(42).uniform(-1, 1, (3, 65, 65))
    step = qg_node.make_step(cfg)
    runs = {}
    for dev in ("cpu", cuda):
        const = qg_node.build_constants(cfg, device=dev, **inputs)
        state = qg_node.init_state(cfg, const, psi0=psi0)
        before = fused_node_rhs.launches, fused_vmg.launches
        cycles = []
        for _ in range(10):
            state, diag = step(state, const, 1e9)
            cycles.append(diag.mg_iters)
        runs[str(dev)] = (state, cycles, fused_node_rhs.launches - before[0],
                          fused_vmg.launches - before[1])
    (cpu, c_cpu, *n_cpu), (gpu, c_gpu, *n_gpu) = runs["cpu"], runs["cuda"]
    assert c_gpu == c_cpu and n_cpu == [0, 0] and n_gpu[0] == 20
    assert (n_gpu[1] > 0) == (solver == "vmg")
    for name in ("q", "psi"):
        want = getattr(cpu, name)
        got = getattr(gpu, name).cpu()
        assert (got - want).abs().max() <= 1e-10 * want.abs().max(), name


# ---------------------------------------------------------------------------
# the doubly periodic and the stochastic msqg: K1's periodic and stochastic
# modes, K2's periodic mode, the steps, K7 on the Fourier basis
# ---------------------------------------------------------------------------

FLOW = dict(upg=(0.02, 0.01, 0.0, 0.0), vpg=(0.01, -0.005, 0.0, 0.0))
STOCH = dict(stochastic=True, tr_stoch=50.0)
# (config overrides, rough input fields) of K1's option sets in the periodic
# kernel (sbc = -1: pp's ghosts follow the flow's non-wrap law, also where
# psipg sets the interior) and of the stochastic variant
MODE_OPTIONS = {
    "uncoupled": (dict(), ()),
    "pg": (dict(**FLOW), ("psipg",)),
    "pg_flsrv": (dict(flsrv=1, **FLOW), ("psipg",)),
    "upg_vpg": (dict(flsrv=1, **FLOW), ()),
    "topo": (dict(), ("topo",)),
    "qforc": (dict(), ("qforc",)),
    "energy_conserv": (dict(energy_conserv=True), ()),
    "stochastic": (dict(**STOCH), ()),
    "stochastic_all": (dict(flsrv=1, **FLOW, **STOCH),
                       ("psipg", "topo", "qforc")),
    "all": (dict(flsrv=1, energy_conserv=True, **FLOW),
            ("psipg", "topo", "qforc")),
}
# nl = 1, 3, 4; partial strips with 16-byte (100) and one-element (130 in
# f32, 257) copies; N = 48: one strip holds the whole width and height, so
# the wrapped halo is the strip's own interior
MODE_SIZES = [(dtype, N, nl) for dtype in ("float64", "float32")
              for N, nl in ((256, 1), (256, 3), (256, 4), (100, 3), (130, 4),
                            (257, 4), (48, 3))]


@pytest.mark.parametrize("dtype,N,nl", MODE_SIZES)
@pytest.mark.parametrize("periodic,option",
                         [(True, o) for o in sorted(MODE_OPTIONS)]
                         + [(False, "stochastic"), (False, "stochastic_all")])
def test_kernel_mode_matches_plain_version(cuda, dtype, N, nl, periodic,
                                           option):
    kw, names = MODE_OPTIONS[option]
    sbc = -1.0 if periodic else (0.5 if option == "stochastic_all" else 0.0)
    cfg = _config(N, nl, dtype, 1000.0, sbc=sbc, **kw)
    const = qg.build_constants(cfg, device=cuda, **_fields(cfg, N, *names))
    psi = _psi(cfg, cuda, N + nl)
    need_q = cfg.energy_conserv or cfg.stochastic
    q = qg.comp_q(cfg, const, psi).contiguous() if need_q else None
    before = fused_rhs.launches
    dq, umax = fused_rhs.rhs_fused(cfg, const, psi, q)
    torch.cuda.synchronize()
    assert fused_rhs.launches == before + 1
    dq_r, umax_r = fused_rhs.rhs_fused_reference(cfg, const, psi, q)
    lim = LIMITS[psi.dtype]
    assert (dq - dq_r).abs().max() <= lim * dq_r.abs().max()
    assert ((umax - umax_r).abs() <= lim * umax_r).all()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("relax", [False, True])
@pytest.mark.parametrize("N,nl,nptr", [(256, 1, 1), (256, 3, 2), (256, 4, 3),
                                       (100, 3, 2), (130, 4, 3), (257, 4, 2),
                                       (48, 3, 1), (48, 3, 2), (64, 2, 5),
                                       (96, 1, 16)])
def test_periodic_tracer_kernel_matches_plain_version(cuda, dtype, relax, N,
                                                      nl, nptr):
    """As the walled test, periodic: nptr = 5 and 16 run the loop over a
    run-time count."""
    Pe = ((1e3, 2e3, 7e2) + tuple(1e3 + 90.0 * j for j in range(3, nptr)))
    ptr_r = ((100.0, 0.0, 13.0) + tuple(5.0 + j for j in range(3, nptr)))
    cfg = _config(N, nl, dtype, sbc=-1.0, nptr=nptr, Pe=Pe[:nptr],
                  ptr_r=ptr_r[:nptr])
    const = qg.build_constants(
        cfg, device=cuda, **_fields(cfg, N, *(["ptr_relax"] if relax else [])))
    psi = _psi(cfg, cuda, N)
    tr = torch.as_tensor(np.random.default_rng(N + 1).uniform(
        -1, 1, (nl, nptr, N, N)), dtype=psi.dtype, device=cuda)
    before = fused_tracer.launches
    dtr = fused_tracer.tracer_fused(cfg, const, psi, tr)
    torch.cuda.synchronize()
    assert fused_tracer.launches == before + 1
    dtr_r = fused_tracer.tracer_fused_reference(cfg, const, psi, tr)
    assert (dtr - dtr_r).abs().max() <= LIMITS[psi.dtype] * dtr_r.abs().max()


def test_periodic_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    cfg = _config(2, 1, "float64", sbc=-1.0, nptr=1, Pe=(1e3,),
                  ptr_r=(100.0,))
    const = qg.build_constants(cfg, device=cuda)
    psi = _psi(cfg, cuda, 0)
    with pytest.raises(ValueError, match="N >= 4"):
        fused_rhs.rhs_fused(cfg, const, psi)
    with pytest.raises(ValueError, match="N >= 4"):
        fused_tracer.tracer_fused(cfg, const, psi, psi[:, None].clone())
    # the periodic kernel reads pp padded and widened (const.pp_t)
    cfg = _config(64, 3, "float32", sbc=-1.0, **FLOW)
    const = qg.build_constants(cfg, device=cuda)
    bad = dataclasses.replace(const, pp_t=const.pp_pad)
    with pytest.raises(ValueError, match="const.pp_t"):
        fused_rhs.rhs_fused(cfg, bad, _psi(cfg, cuda, 1))
    stoch = _config(64, 3, "float32", **STOCH)
    with pytest.raises(ValueError, match="needs q"):
        fused_rhs.rhs_fused(stoch, qg.build_constants(stoch, device=cuda),
                            _psi(stoch, cuda, 2))


def _verron128(**kw):
    base = dict(N=128, nl=3, L0=80, Rom=0.025, Ekb=0.002, tau0=1e-4,
                Re4=1563, beta=0.5, Fr=(0.0023669, 0.0076173),
                dh=(0.06, 0.14, 0.8), DT=5e-2, tend=500., dtout=1., CFL=0.6,
                dtype="float64", solver="spectral")
    return QGConfig(**{**base, **kw}).validate()


@pytest.mark.parametrize("variant", ["periodic", "periodic_coupled",
                                     "periodic_mg", "stochastic"])
def test_mode_cuda_step_matches_cpu_step(cuda, variant):
    """20 f64 steps at 128^2 x 3 from one numpy IC: periodic (spectral
    rfft2), periodic with upg/vpg, _LS_RV, topography, a 3-D forcing and
    two tracers, periodic with the multigrid (the same V-cycles; a
    periodic solve launches no K3 or K4), and stochastic at amp_stoch = 0
    (each side draws from its own generator, and adds none of it)."""
    kw = dict(periodic=dict(sbc=-1.0),
              periodic_coupled=dict(sbc=-1.0, flsrv=1, nptr=2,
                                    Pe=(1e3, 2e3), ptr_r=(100.0, 0.0),
                                    upg=FLOW["upg"][:3], vpg=FLOW["vpg"][:3]),
              periodic_mg=dict(sbc=-1.0, solver="mg"),
              stochastic=dict(amp_stoch=0.0, **STOCH))[variant]
    cfg = _verron128(**kw)
    rng = np.random.default_rng(42)
    psi0 = 1e-3 * rng.uniform(-1, 1, (3, 128, 128))
    fields, tr0 = {}, None
    if variant == "periodic_coupled":
        fields = dict(topo=0.05 * np.sin(np.linspace(0, 2 * np.pi, 128))
                      [:, None] * np.ones((128, 128)),
                      qforc=1e-5 * rng.standard_normal((3, 128, 128)))
        tr0 = 1e-3 * rng.uniform(-1, 1, (3, 2, 128, 128))
    out = {}
    for dev in ("cpu", cuda):
        const = qg.build_constants(cfg, device=dev, **fields)
        state = qg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
        gen = torch.Generator(device=dev).manual_seed(1) \
            if cfg.stochastic else None
        step = qg.make_step(cfg, gen)
        before = (fused_rhs.launches, fused_tracer.launches,
                  fused_mg.sweep_launches)
        cycles = []
        for _ in range(20):
            state, diag = step(state, const, 1e9)
            cycles.append(diag.mg_iters)
        out[str(dev)] = (state, cycles, fused_rhs.launches - before[0],
                         fused_tracer.launches - before[1],
                         fused_mg.sweep_launches - before[2])
    cpu, gpu = out["cpu"], out["cuda"]
    assert cpu[2:] == (0, 0, 0)
    assert gpu[2:] == (40, 40 if tr0 is not None else 0, 0)
    assert gpu[1] == cpu[1]
    for name in ("q", "psi") + (("tracers",) if tr0 is not None else ()):
        want = getattr(cpu[0], name)
        got = getattr(gpu[0], name).cpu()
        assert (got - want).abs().max() <= 1e-10 * want.abs().max(), name


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("N", [128, 1024])
def test_spectral_kernel_on_the_fourier_basis(cuda, dtype, N):
    """K7 with the periodic Fourier basis and the naturally ordered inv_den
    (build_spectral(periodic=True, transform="matmul", fused_mm=True))
    against the cuBLAS chain; in f32 its error against the f64 chain within
    4 times the FP32 chain's."""
    nl = 4
    spec = spectral.build_spectral(
        nl=nl, N=N, L0=80.0, dh=np.full(nl, 1.0 / nl),
        s_profile=np.full(nl - 1, (0.003 / 0.025) ** 2), periodic=True,
        dtype=getattr(torch, dtype), transform="matmul", fused_mm=True,
        device=cuda)
    qm = torch.as_tensor(np.random.default_rng(N).standard_normal(
        (nl, N, N)), dtype=getattr(torch, dtype), device=cuda)
    pm = fused_spectral.fused_mm_solve(spec.S, spec.inv_den, qm, spec.mm)
    want = spectral._mm_solve(spec.S, spec.inv_den, qm)
    scale = want.abs().max()
    limit = 1e-12 if dtype == "float64" else 1e-5
    assert (pm - want).abs().max() <= limit * scale
    if dtype == "float32":
        exact = spectral._mm_solve(spec.S.double(), spec.inv_den.double(),
                                   qm.double())
        err = (pm.double() - exact).abs().max()
        err32 = (want.double() - exact).abs().max()
        assert err <= 4 * err32


DRIVER_RUNS = {
    "walled": {},
    "coupled": dict(nptr=2, Pe=(1e3, 2e3), ptr_r=(100.0, 0.0)),
    "periodic": dict(sbc=-1.0),
}


@pytest.mark.parametrize("run", list(DRIVER_RUNS))
def test_driver_on_the_card_matches_the_cpu(cuda, tmp_path, run):
    """run_qg with the wavelet filter (dtflt = 0.25), the energy budget
    (ediag = 0) and an OutputWriter, 128^2 x 3 f64 to tend = 0.75 (about
    30 steps, two output and two filter events), on the card and on the
    CPU from one numpy IC: walled, with bench's coupling (psipg, a sine
    topography, two tracers) and periodic. The final q, psi, qof and the
    six energy fields to 1e-10 of their maxima, the KE log to 1e-10; the
    same files, each within float32 rounding (2^-23 of its max|value|)."""
    import os

    from msom_tpu_torch import driver
    from msom_tpu_torch.io.bas import read_bas
    from msom_tpu_torch.models import qg_energy
    cfg = _verron128(dtflt=0.25, dtout=0.5, tend=0.75, ediag=0, afilt=7.0,
                     **DRIVER_RUNS[run])
    rng = np.random.default_rng(42)
    psi0 = 1e-3 * rng.uniform(-1, 1, (3, 128, 128))
    fields, tr0 = {}, None
    if run == "coupled":
        y = (np.arange(128) + 0.5) * cfg.delta
        gyre = np.sin(np.pi * y / cfg.L0)
        fields = dict(psipg=0.01 * gyre[None, :, None]
                      * np.ones((3, 128, 128)),
                      topo=0.05 * np.outer(gyre,
                                           np.sin(2 * np.pi * y / cfg.L0)))
        tr0 = 1e-3 * rng.uniform(-1, 1, (3, 2, 128, 128))
    out = {}
    for dev in ("cpu", "cuda"):
        const = qg.build_constants(cfg, device=dev, **fields)
        state = qg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
        logs = []
        hooks = driver.RunHooks(on_log=lambda *a: logs.append(a))
        hooks.on_output = driver.OutputWriter(cfg, const,
                                              outdir=str(tmp_path / dev))
        before = fused_rhs.launches
        state, energy = driver.run_qg(cfg, const=const, state=state,
                                      hooks=hooks)
        out[dev] = state, energy, logs, fused_rhs.launches - before
    (cs, ce, clog, cn), (gs, ge, glog, gn) = out["cpu"], out["cuda"]
    assert cn == 0 and gn == 2 * int(gs.i) and int(gs.i) == int(cs.i)
    assert int(gs.nbar) == int(cs.nbar) == 2
    pairs = [(getattr(gs, n), getattr(cs, n)) for n in ("q", "psi", "qof")]
    pairs += [(getattr(ge, n), getattr(ce, n)) for n in qg_energy.FIELDS]
    for got, want in pairs:
        assert (got.cpu() - want).abs().max() <= 1e-10 * want.abs().max()
    assert len(glog) == len(clog) == int(gs.i)
    for g, c in zip(glog, clog):
        assert g[0] == c[0] and abs(g[3] - c[3]) <= 1e-10 * abs(c[3])
    names = sorted(os.listdir(tmp_path / "cpu"))
    assert names == sorted(os.listdir(tmp_path / "cuda"))
    for name in (n for n in names if n.endswith(".bas")):
        got = read_bas(str(tmp_path / "cuda" / name))[0]
        want = read_bas(str(tmp_path / "cpu" / name))[0]
        assert np.abs(got - want).max() <= 2.0 ** -23 * np.abs(want).max()


NODE_DRIVER_RUNS = {
    "walled": ({}, False),
    "coastline": (dict(solver="vmg"), True),
    "periodic": (dict(bc_fac=-1.0), False),
    "stochastic": (dict(stochastic=True, amp_stoch=0.0, L_filt_stoch=20.0),
                   False),
}


def _node128(**kw):
    """bench.py's node physics (bench.py:178-185) at 128^2 x 3 in f64, with
    the events of 33 steps: three vars.nc records, four diag rows, two
    filter events."""
    from msom_tpu_torch.models.qg_node import NodeQGConfig
    base = dict(N=128, nl=3, L0=100.0, f0=46.5, beta=0.5, hEkb=1e-3,
                tau0=1e-3, nu=2.5, dh=(1 / 3, 1 / 3, 1 / 3), N2=(1.0, 1.0),
                noise_init=1e-3, bc_fac=1.0, DT=5e-2, CFL=0.2,
                TOLERANCE=1e-8, dtflt=0.125, dtout=0.125, dtdiag=0.0625,
                tend=0.25, Lfmax=30.0, Lfmin=10.0, dtype="float64")
    base.update(kw)
    return NodeQGConfig(**base)


@pytest.mark.parametrize("run", list(NODE_DRIVER_RUNS))
def test_node_driver_on_the_card_matches_the_cpu(cuda, tmp_path, run):
    """run_node on the card and on the CPU from one numpy IC: the final q,
    psi and psi_f, the diag rows' values and the KE log to 1e-10 of their
    maxima; every vars.nc record within float32 rounding (2^-23 of its
    max|value|); K5 twice a step on the card on a walled grid, never on
    the CPU; K6 on the card iff the inversion is vmg."""
    from msom_tpu_torch import driver_node
    from msom_tpu_torch.io.netcdf import read_nc
    from msom_tpu_torch.models import fused_node_rhs, qg_node
    from msom_tpu_torch.solvers import fused_vmg
    over, masked = NODE_DRIVER_RUNS[run]
    cfg = _node128(**over)
    inputs = dict(mask=coastline_mask(128)) if masked else {}
    n = 128 if cfg.periodic else 129
    rng = np.random.default_rng(42)
    psi0 = 1e-3 * rng.uniform(-1, 1, (3, n, n))
    out = {}
    for dev in ("cpu", "cuda"):
        const = qg_node.build_constants(cfg, device=dev, **inputs)
        state = qg_node.init_state(cfg, const, psi0=psi0)
        output = driver_node.NodeOutput(cfg, str(tmp_path / dev))
        rows, logs = [], []
        write_row = output.diag_row

        def diag_row(*v, rows=rows, write_row=write_row):
            rows.append(v)
            write_row(*v)

        output.diag_row = diag_row
        before = fused_node_rhs.launches, fused_vmg.launches
        state, _ = driver_node.run_node(
            cfg, const=const, state=state, output=output, restart=None,
            hooks=driver_node.RunHooks(
                on_log=lambda *a, logs=logs: logs.append(a)),
            generator=torch.Generator(device=dev).manual_seed(3))
        out[dev] = (state, np.array(rows), logs,
                    fused_node_rhs.launches - before[0],
                    fused_vmg.launches - before[1],
                    read_nc(str(tmp_path / dev / "vars.nc"), ["psi", "q"],
                            None))
    (cs, crow, clog, c5, c6, cnc), (gs, grow, glog, g5, g6, gnc) = \
        out["cpu"], out["cuda"]
    steps = int(gs.i)
    assert int(cs.i) == steps and 20 <= steps <= 40
    assert c5 == c6 == 0
    assert g5 == (0 if cfg.periodic else 2 * steps) and (g6 > 0) == masked
    for name in ("q", "psi", "psi_f"):
        want = getattr(cs, name)
        got = getattr(gs, name).cpu()
        assert (got - want).abs().max() <= 1e-10 * want.abs().max(), name
    assert crow.shape == grow.shape == (4, 4)
    for k in range(1, 4):
        assert np.abs(grow[:, k] - crow[:, k]).max() \
            <= 1e-10 * np.abs(crow[:, k]).max()
    assert len(glog) == len(clog) == steps
    for g, c in zip(glog, clog):
        assert g[0] == c[0] and abs(g[3] - c[3]) <= 1e-10 * abs(c[3])
    np.testing.assert_array_equal(gnc[1], cnc[1])
    assert len(cnc[1]) == 3
    for name in ("psi", "q"):
        got, want = gnc[0][name], cnc[0][name]
        assert got.shape == want.shape == (3, 3, 129, 129)
        assert np.abs(got - want).max() <= 2.0 ** -23 * np.abs(want).max()


@pytest.mark.parametrize("periodic", [False, True])
def test_node_noise_draw_on_the_card(cuda, periodic):
    """The card's white draw (a seeded CUDA generator, 4 x 1025^2 f32) has
    its normalised mean and std within four standard errors of a standard
    normal sample's; the filtered noise is finite and, walled, zero off the
    mask; a draw from a CPU generator is refused."""
    from msom_tpu_torch.models import qg_node
    cfg = _node128(N=1024, nl=4, dh=(0.25,) * 4, N2=(1.0,) * 3,
                   dtype="float32", stochastic=True, amp_stoch=1e-6,
                   L_filt_stoch=20.0, bc_fac=-1.0 if periodic else 1.0)
    const = qg_node.build_constants(cfg, device="cuda")
    n = 1024 if periodic else 1025
    gen = torch.Generator(device="cuda").manual_seed(2)
    xi = qg_node.draw_white(cfg, const, gen, (4, n, n)).double() \
        / cfg.amp_stoch
    m = xi.numel()
    assert abs(xi.mean().item()) < 4 / np.sqrt(m)
    assert abs(xi.std().item() - 1) < 4 / np.sqrt(2 * m)
    noise = qg_node.generate_noise(cfg, const, gen, (4, n, n))
    assert bool(torch.isfinite(noise).all()) and noise.abs().max() > 0
    if not periodic:
        assert not (noise * (1 - const.mask)).any()
    with pytest.raises(ValueError, match="generator"):
        qg_node.draw_white(cfg, const, torch.Generator(), (4, n, n))


# ---------------------------------------------------------------------------
# the y-profile direct solve's sweeps (KV), varRo, newqg and SQG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("N,K,nl", KV_SIZES)
def test_vary_sweep_matches_plain_version(cuda, dtype, N, K, nl):
    """KV against the row loop on block inverses whose chain is stable
    (|a W| row sums 1/2): 1e-11 (f64) and 1e-5 (f32) of max|psi|, at
    chip_smoke.py's KV_SIZES (stages longer than N and N not a multiple of
    one, partial column blocks, the element-copy case, nl 2-8)."""
    from msom_tpu_torch.solvers import fused_vary
    W, X, a = kv_problem(N, K, nl, dtype)
    before = fused_vary.launches
    got = fused_vary.sweep(W, X, a)
    assert fused_vary.launches == before + 1
    want = fused_vary.sweep_reference(W, X, a)
    lim = {torch.float32: 1e-5, torch.float64: 1e-11}[X.dtype]
    assert (got - want).abs().max() <= lim * want.abs().max()


def test_vary_sweep_refuses_a_geometry_that_does_not_fit(cuda):
    """The C launch refuses a geometry it was not built for or whose ring
    does not fit, with no launch counted; the same inputs with the
    wrapper's geometry launch and match the plain version."""
    from msom_tpu_torch.solvers import fused_vary
    N, K, nl = 64, 257, 4
    W, X, a = kv_problem(N, K, nl, "float32", seed=7)
    g = fused_vary.geometry(nl, N, K, 4)
    assert not g.tma       # Kx * 4 bytes is not a multiple of 16

    def shaped(**kw):      # another geometry with its own shared memory
        h = dataclasses.replace(g, **kw)
        return dataclasses.replace(h, smem=fused_vary.smem_bytes(
            nl, 4, h.cols, h.rows, h.stages))

    bad = {
        "TMA on unaligned strides": dataclasses.replace(g, tma=True),
        "lanes": dataclasses.replace(g, lanes=2),
        "columns the kernel was not built for": shaped(cols=16),
        "shared memory": dataclasses.replace(g, smem=g.smem - 128),
        "rows the kernel was not built for": shaped(rows=g.rows + 2),
        "too many stages": shaped(stages=fused_vary.MAX_STAGES + 1),
        "a ring over the limit": shaped(stages=25),
    }
    assert bad["a ring over the limit"].smem > fused_vary.MAX_SMEM
    for label, geom in bad.items():
        before = fused_vary.launches
        with pytest.raises(RuntimeError, match="vary_sweep launch failed"):
            fused_vary.sweep(W, X, a, geom)
        assert fused_vary.launches == before, label
    got = fused_vary.sweep(W, X, a, g)
    want = fused_vary.sweep_reference(W, X, a)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_vary_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from msom_tpu_torch.solvers import fused_vary
    W = torch.zeros((3, 3, 16, 16), device=cuda)
    X = torch.zeros((3, 16, 16), device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        fused_vary.sweep(W.half(), X.half(), 1.0)
    with pytest.raises(ValueError, match="W must"):
        fused_vary.sweep(W.double(), X, 1.0)
    with pytest.raises(ValueError, match="X must"):
        fused_vary.sweep(W, X.transpose(1, 2), 1.0)
    with pytest.raises(ValueError, match="nl = 9"):
        fused_vary.sweep(torch.zeros((9, 9, 4, 4), device=cuda),
                         torch.zeros((9, 4, 4), device=cuda), 1.0)


@pytest.mark.parametrize("solver", ["spectral", "mg"])
def test_varro_cuda_step_matches_cpu_step(cuda, solver):
    """varRo, f64, 64^2 x 3, 10 steps: q and psi to 1e-10 with the same
    V-cycles; KV twice a step with the spectral solve, K1 twice a step."""
    from msom_tpu_torch.solvers import fused_vary
    cfg = _config(64, 3, "float64", varRo=1)
    cfg = dataclasses.replace(cfg, solver=solver).validate()
    psi0 = 1e-3 * np.random.default_rng(3).uniform(-1, 1, (3, 64, 64))
    out = {}
    for where in ("cpu", "cuda"):
        const = qg.build_constants(cfg, device=where)
        state = qg.init_state(cfg, const, psi0=psi0)
        step = qg.make_step(cfg)
        n0, k0 = fused_vary.launches, fused_rhs.launches
        cycles = []
        for _ in range(10):
            state, diag = step(state, const, 1e9)
            cycles.append(diag.mg_iters)
        out[where] = (state, cycles, fused_vary.launches - n0,
                      fused_rhs.launches - k0)
    (cs, cc, cv, ck), (gs, gc, gv, gk) = out["cpu"], out["cuda"]
    assert gc == cc and cv == ck == 0 and gk == 20
    assert gv == (20 if solver == "spectral" else 0)
    for name in ("q", "psi"):
        want = getattr(cs, name)
        assert (getattr(gs, name).cpu() - want).abs().max() \
            <= 1e-10 * want.abs().max()


def test_newqg_and_sqg_cuda_steps_match_cpu_steps(cuda):
    """newqg (nl = 2 with gp_low, mg, walled: K3/K4 on the card) and SQG
    (K6 on the card), f64, 64^2, 10 steps: the fields to 1e-10 with the
    same V-cycles."""
    from msom_tpu_torch.models import newqg, sqg
    from msom_tpu_torch.models.qg_node import NodeQGConfig
    from msom_tpu_torch.solvers import fused_vmg
    ncfg = newqg.NewQGConfig(N=64, nl=2, L0=100.0, tau0=1e-3, nu=5.0,
                             beta=0.5, gp_low=2.0, dh=(0.5, 0.5), f0=2.0,
                             DT=5e-2, CFL=0.2, TOLERANCE=1e-8)
    scfg = NodeQGConfig(N=64, nl=3, L0=1.0, f0=1.0, beta=0.5, nu=1e-4,
                        dh=(0.2, 0.3, 0.5), N2=(1.0, 0.5, 0.25),
                        noise_init=1e-2, DT=1e-3, CFL=0.4, TOLERANCE=1e-10,
                        dtype="float64")
    rng = np.random.default_rng(4)
    psi_n = 1e-2 * rng.uniform(-1, 1, (2, 64, 64))
    psi_s = 1e-2 * rng.uniform(-1, 1, (3, 65, 65))
    bs = 1e-2 * rng.uniform(-1, 1, (65, 65))
    bs[0] = bs[-1] = bs[:, 0] = bs[:, -1] = 0.0
    out = {}
    for where in ("cpu", "cuda"):
        _, lam = newqg.build_levels(ncfg, where)
        ns = newqg.init_state(ncfg, lam, psi0=psi_n, device=where)
        nstep = newqg.make_step(ncfg, device=where)
        sc = sqg.build_constants(scfg, device=where)
        ss = sqg.init_state(scfg, sc, psi0=psi_s, bs0=bs)
        sstep = sqg.make_step(scfg)
        k0, v0 = fused_mg.sweep_launches, fused_vmg.launches
        cycles = []
        for _ in range(10):
            ns, nd = nstep(ns, 1e9)
            ss, sd = sstep(ss, sc, 1e9)
            cycles.append((nd.mg_iters, sd.mg_iters))
        out[where] = (ns, ss, cycles, fused_mg.sweep_launches - k0,
                      fused_vmg.launches - v0)
    (cn, cs, cc, ck3, ck6), (gn, gs, gc, gk3, gk6) = out["cpu"], out["cuda"]
    assert gc == cc and ck3 == ck6 == 0 and gk3 > 0 and gk6 > 0
    for got, want in ((gn.q, cn.q), (gn.psi, cn.psi), (gs.q, cs.q),
                      (gs.bs, cs.bs), (gs.psi, cs.psi)):
        assert (got.cpu() - want).abs().max() <= 1e-10 * want.abs().max()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("sbc", [0.0, 1.0, -1.0])
@pytest.mark.parametrize("N,nl,world", [(64, 3, 4), (160, 4, 4), (96, 1, 2)])
def test_rows_kernels_equal_the_whole_domain_launch(cuda, dtype, sbc, N, nl,
                                                    world):
    """K1's rows mode (pp, _LS_RV, topography, qforc, ENERGY_CONSERV) and
    K2's (two tracers, a relaxation field) on `world` virtual shards
    (shards of 16, 40: a 32-row strip and an 8-row one, and 48 rows),
    walled, partial slip and periodic: put together, the whole-domain
    launch within 4 ulp of max|out| (bit for bit but where the rows build
    contracts a multiply-add differently), within LIMITS of the plain rows
    version, one rows launch a shard each."""
    from msom_tpu_torch.parallel import halo
    cfg = _config(N, nl, dtype, 1000.0, flsrv=1, energy_conserv=True,
                  sbc=sbc, nptr=2, Pe=(1e3, 2e3), ptr_r=(100.0, 0.0))
    const = qg.build_constants(cfg, device=cuda, **_fields(
        cfg, N, "psipg", "topo", "qforc", "ptr_relax"))
    psi = _psi(cfg, cuda, N + nl)
    q = qg.comp_q(cfg, const, psi).contiguous()
    tr = _psi(cfg, cuda, N)[:, None].expand(nl, 2, N, N) \
        * torch.tensor([1.0, -0.5], dtype=psi.dtype, device=cuda)[:, None,
                                                                   None]
    tr = tr.contiguous()
    wrap = sbc == -1.0
    n = N // world
    pe, qe = (halo.split_rows8(f, world, wrap) for f in (psi, q))
    te = halo.split_rows8(tr.reshape(-1, N, N), world, wrap)
    before = fused_rhs.rows_launches, fused_tracer.rows_launches
    got, dtrs = [], []
    for d in range(world):
        rows = slice(d * n, (d + 1) * n)
        got.append(fused_rhs.rhs_fused(cfg, const, psi[:, rows],
                                       psi_ext=pe[d], q_ext=qe[d],
                                       row0=d * n))
        dtrs.append(fused_tracer.tracer_fused(
            cfg, const, psi[:, rows], tr[..., rows, :], psi_ext=pe[d],
            tr_ext=te[d], row0=d * n))
        dq_r, um_r = fused_rhs.rhs_fused_reference(
            cfg, const, psi[:, rows], psi_ext=pe[d], q_ext=qe[d], row0=d * n)
        dtr_r = fused_tracer.tracer_fused_reference(
            cfg, const, psi[:, rows], tr[..., rows, :], psi_ext=pe[d],
            tr_ext=te[d], row0=d * n)
        lim = LIMITS[psi.dtype]
        assert (got[-1][0] - dq_r).abs().max() <= lim * dq_r.abs().max()
        assert ((got[-1][1] - um_r).abs() <= lim * um_r).all()
        assert (dtrs[-1] - dtr_r).abs().max() <= lim * dtr_r.abs().max()
    torch.cuda.synchronize()
    assert (fused_rhs.rows_launches - before[0],
            fused_tracer.rows_launches - before[1]) == (world, world)
    # the rows kernels are their own build of the same source: bit for bit
    # the whole-domain launch, or within 4 ulp of max|out| where the two
    # builds contract a multiply-add differently (chip_smoke.ROWS_ULPS)
    ulp = 4 * torch.finfo(psi.dtype).eps
    dq, umax = fused_rhs.rhs_fused(cfg, const, psi, q)
    dtr = fused_tracer.tracer_fused(cfg, const, psi, tr)
    for g, w in ((torch.cat([g[0] for g in got], dim=1), dq),
                 (torch.stack([g[1] for g in got]).amax(0), umax),
                 (torch.cat(dtrs, dim=2), dtr)):
        assert (g - w).abs().max() <= ulp * w.abs().max()


def test_rows_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """Rows mode needs slabs of n_loc + 16 rows, q_ext where q is read,
    tr_ext, and a row0 that keeps the shard in the domain."""
    cfg = _config(64, 3, "float32", energy_conserv=True, nptr=1, Pe=(1e3,),
                  ptr_r=(10.0,))
    const = qg.build_constants(cfg, device=cuda)
    psi = _psi(cfg, cuda, 0)[:, :32]
    ext = torch.zeros((3, 48, 64), dtype=psi.dtype, device=cuda)
    with pytest.raises(ValueError, match="psi_ext"):
        fused_rhs.rhs_fused(cfg, const, psi, psi_ext=ext[:, :40],
                            q_ext=ext, row0=0)
    with pytest.raises(ValueError, match="q_ext"):
        fused_rhs.rhs_fused(cfg, const, psi, psi_ext=ext, row0=0)
    with pytest.raises(ValueError, match="row0"):
        fused_rhs.rhs_fused(cfg, const, psi, psi_ext=ext, q_ext=ext,
                            row0=40)
    tr = torch.zeros((3, 1, 32, 64), dtype=psi.dtype, device=cuda)
    with pytest.raises(ValueError, match="tr_ext"):
        fused_tracer.tracer_fused(cfg, const, psi, tr, psi_ext=ext, row0=0)


@pytest.mark.parametrize("tracers", [False, True])
@pytest.mark.parametrize("direction", [1.0, -1.0])
def test_api_tendency_on_the_card_matches_the_cpu(cuda, direction, tracers):
    """api.qg_tendency, f64, 64^2 x 3 (Re, Re4 and both Ekman terms on, so
    that direction = -1 flips each): one K1 launch (and one K2 with two
    tracers) on the card, none on the CPU, and the card's tendencies to
    1e-11 of the CPU's."""
    from msom_tpu_torch import api
    kw = dict(nptr=2, Pe=(1e3, 2e3), ptr_r=(100.0, 0.0)) if tracers else {}
    cfg = _config(64, 3, "float64", Re=500.0, **kw)
    rng = np.random.default_rng(11)
    psi0 = 1e-3 * rng.uniform(-1, 1, (3, 64, 64))
    tr0 = rng.uniform(-1, 1, (3, 2, 64, 64)) if tracers else None
    out, launched = {}, {}
    for where in ("cpu", "cuda"):
        const = qg.build_constants(cfg, device=where)
        state = qg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
        n1, n2 = fused_rhs.launches, fused_tracer.launches
        got = api.qg_tendency(cfg, const, state.q, direction,
                              tracers=state.tracers)
        out[where] = got if tracers else (got,)
        launched[where] = (fused_rhs.launches - n1,
                           fused_tracer.launches - n2)
    assert launched == {"cpu": (0, 0), "cuda": (1, int(tracers))}
    for g, w in zip(out["cuda"], out["cpu"]):
        assert (g.cpu() - w).abs().max() <= 1e-11 * w.abs().max()


def test_api_bfn_integrate_on_the_card_matches_the_cpu(cuda):
    """bfn_integrate, f64, 64^2 x 3, four AB3 steps forward in q and four
    backward in psi (dt < 0) with a nudge that reads the step index: one
    K1 launch a step, the card's result to 1e-10 of the CPU's."""
    from msom_tpu_torch import api
    cfg = _config(64, 3, "float64", Re=500.0)
    psi0 = 1e-3 * np.random.default_rng(12).uniform(-1, 1, (3, 64, 64))
    out = {}
    for where in ("cpu", "cuda"):
        const = qg.build_constants(cfg, device=where)
        q0 = qg.init_state(cfg, const, psi0=psi0).q
        n0 = fused_rhs.launches

        def nudge(q, i):
            return -(0.5 + 0.25 * i) * q

        q = api.bfn_integrate(cfg, const, q0, 4, dt=1e-2, nudge_fn=nudge)
        psi = api.bfn_integrate(cfg, const, api.q_to_psi(cfg, const, q), 4,
                                flag_q=False, direction=-1.0, dt=-1e-2,
                                nudge_fn=nudge)
        out[where] = (q, psi, fused_rhs.launches - n0)
    assert out["cpu"][2] == 0 and out["cuda"][2] == 8
    for g, w in zip(out["cuda"][:2], out["cpu"][:2]):
        assert (g.cpu() - w).abs().max() <= 1e-10 * w.abs().max()


def test_api_pg_tendency_on_the_card_matches_the_cpu(cuda):
    """api.pg_tendency, f64, the 8^2 x 3 PG config: the card's numpy
    vector to 1e-12 of the CPU's at random vectors."""
    from msom_tpu_torch import api
    from msom_tpu_torch.models import mspg
    from msom_tpu_torch.params import PGConfig
    cfg = PGConfig(N=8, nl=3, ys=0.3, r=0.05, tau_s=3e-2, tau0=0.05,
                   kv=5e-4, kh=5e-4, omega=0.2, DT=5e-3, dtype="float64")
    consts = {w: mspg.build_constants(cfg, device=w) for w in ("cpu", "cuda")}
    n = 3 * 8 * 8 + 2 * 3 * 8 * 9
    for x in np.random.default_rng(13).standard_normal((3, n)):
        want = api.pg_tendency(cfg, consts["cpu"], x)
        got = api.pg_tendency(cfg, consts["cuda"], x)
        assert isinstance(got, np.ndarray) and got.shape == (n,)
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
