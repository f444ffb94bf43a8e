"""The port's spectral PV inversion (msom_tpu_torch.solvers) against the
JAX package's on identical float64 inputs: the derived constants at 1e-13,
the transforms and the solve at 1e-12 (each output sums up to N products,
in another order than XLA's), and the solve's residual in the model's own
operator (comp_q); and the plain version of the fused basis-matmul solve
(kernel K7) against the JAX package's Pallas kernel in interpret mode, in
float32 at the 1e-4 of tests/test_spectral.py (the Pallas kernel's 3-pass
bf16 products against full-f32 ones)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msom_tpu.solvers import ctdst as jctdst
from msom_tpu.solvers import pallas_spectral
from msom_tpu.solvers import spectral as jspec
from msom_tpu_torch.models import qg as tqg
from msom_tpu_torch.params import QGConfig
from msom_tpu_torch.solvers import ctdst as tctdst
from msom_tpu_torch.solvers import fused_spectral
from msom_tpu_torch.solvers import spectral as tspec

torch.set_num_threads(1)

L0 = 80.0
DH = (0.06, 0.14, 0.8)
FR = (0.0023669, 0.0076173)
ROM = 0.025


def _sprof(nl):
    return None if nl == 1 else (np.asarray(FR[:nl - 1]) / ROM) ** 2


def _build(nl, N, transform, dtype="float64"):
    kw = dict(nl=nl, N=N, L0=L0, dh=np.asarray(DH[:nl] if nl > 1 else (1.0,)),
              s_profile=_sprof(nl), periodic=False, transform=transform)
    j = jspec.build_spectral(dtype=jnp.dtype(dtype), **kw)
    t = tspec.build_spectral(dtype=getattr(torch, dtype), device="cpu", **kw)
    return j, t


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("N", [15, 16, 64])
def test_dst2_matches_jax_and_sine_matrix(N):
    rng = np.random.default_rng(N)
    x = rng.standard_normal((2, N, N))
    S = tspec.dst_matrix(N)
    np.testing.assert_array_equal(S, jspec.dst_matrix(N))
    xt = torch.as_tensor(x)
    for axis in (-1, -2):
        got = tspec.dst2(xt, axis)
        _close(got, jspec.dst2(jnp.asarray(x), axis), 1e-13)
        want = np.moveaxis(np.moveaxis(x, axis, -1) @ S.T, -1, axis)
        _close(got, want, 1e-13)
        _close(tspec.idst2(got, axis), x, 1e-13)


@pytest.mark.parametrize("N", [32, 64, 512])
def test_fold_matches_jax(N):
    tf, tperm = tctdst.build_fold(N, torch.float64, "cpu")
    jf, jperm = jctdst.build_fold(N, jnp.float64)
    assert (tf.N, tf.L) == (jf.N, jf.L)
    np.testing.assert_array_equal(tperm, jperm)
    for a, b in zip(tf.Mes + (tf.Mleaf,), jf.Mes + (jf.Mleaf,)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rng = np.random.default_rng(N)
    x = rng.standard_normal((2, N, N))
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    for tfn, jfn in ((tctdst.fdst_x, jctdst.fdst_x),
                     (tctdst.fdst_y, jctdst.fdst_y),
                     (tctdst.ifdst_x, jctdst.ifdst_x),
                     (tctdst.ifdst_y, jctdst.ifdst_y)):
        _close(tfn(tf, xt), jfn(jf, xj), 1e-12)
    # forward then inverse is the identity; forward is the permuted DST-II
    _close(tctdst.ifdst_x(tf, tctdst.fdst_x(tf, xt)), x, 1e-12)
    _close(tctdst.fdst_x(tf, xt), x @ tspec.dst_matrix(N)[tperm].T, 1e-12)


def test_fold_rejects_sizes_without_a_fold():
    assert tctdst.build_fold(24, torch.float64, "cpu") == (None, None)
    assert tctdst.build_fold(8, torch.float64, "cpu") == (None, None)
    assert tctdst.default_levels(2048) == jctdst.default_levels(2048) == 3


@pytest.mark.parametrize("transform", ["auto", "matmul", "factored", "fft"])
@pytest.mark.parametrize("nl", [1, 3])
def test_build_spectral_constants_match_jax(nl, transform):
    j, t = _build(nl, 64, transform)
    _close(t.inv_den, j.inv_den, 1e-13)
    if nl > 1:
        _close(t.l2m, j.l2m, 1e-13)
        _close(t.m2l, j.m2l, 1e-13)
    else:
        assert t.l2m is None and t.m2l is None
    assert (t.fac is None) == (j.fac is None)
    if t.fac is not None:
        for a, b in zip(t.fac.Mes + (t.fac.Mleaf,), j.fac.Mes + (j.fac.Mleaf,)):
            _close(a, b, 1e-13)
    else:
        assert (t.S is None) == (j.S is None)
        if t.S is not None:
            _close(t.S, j.S, 1e-13)


@pytest.mark.parametrize("N,dtype,path", [
    (64, "float64", "fft"), (64, "float32", "matmul"),
    (96, "float32", "matmul"), (512, "float32", "fold"),
    (384, "float32", "matmul")])
def test_auto_transform_selection_matches_jax(N, dtype, path):
    """spectral.py:195-208: the fold for f32 at power-of-2 512 <= N <=
    4096, the basis matmul for other f32 N <= 4096, the FFT DST in f64."""
    j, t = _build(1, N, "auto", dtype)
    got = "fold" if t.fac is not None else "matmul" if t.S is not None \
        else "fft"
    want = "fold" if j.fac is not None else "matmul" if j.S is not None \
        else "fft"
    assert got == want == path
    _close(t.inv_den, j.inv_den, 1e-6 if dtype == "float32" else 1e-13)


@pytest.mark.parametrize("transform", ["auto", "matmul", "factored"])
@pytest.mark.parametrize("nl", [1, 3])
def test_solve_spectral_matches_jax(nl, transform):
    j, t = _build(nl, 64, transform)
    rng = np.random.default_rng(nl)
    q = rng.standard_normal((nl, 64, 64))
    got = tspec.solve_spectral(t, torch.as_tensor(q))
    want = jspec.solve_spectral(j, jnp.asarray(q))
    _close(got, want, 1e-12)


@pytest.mark.parametrize("transform", ["auto", "matmul", "factored"])
def test_solve_spectral_residual_in_comp_q(transform):
    """psi = invert_q(q) satisfies comp_q(psi) = q to roundoff (the model's
    own 5-point Laplacian + stretching with Dirichlet ghosts)."""
    cfg = QGConfig(N=64, nl=3, L0=L0, Rom=ROM, Fr=FR, dh=DH, beta=0.5,
                   dtype="float64", solver="spectral",
                   transform=transform).validate()
    const = tqg.build_constants(cfg, device="cpu")
    rng = np.random.default_rng(11)
    q = torch.as_tensor(rng.standard_normal((3, 64, 64)))
    psi, _ = tqg.invert_q(cfg, const, None, q)
    res = (tqg.comp_q(cfg, const, psi) - q).abs().max() / q.abs().max()
    assert res < 1e-12, float(res)


def _modal_problem(nl, N, dtype, seed=0):
    """(S, inv_den, qm) of the Dirichlet matmul solve as numpy arrays."""
    _, t = _build(nl, N, "matmul", dtype)
    rng = np.random.default_rng(seed)
    qm = rng.standard_normal((nl, N, N)).astype(dtype)
    return t.S.numpy(), t.inv_den.numpy(), qm


def test_mm_solve_matches_pallas_fused_solve():
    """spectral._mm_solve (the plain version of K7) in float32 against
    pallas_spectral.fused_mm_solve(interpret=True) at N = 128, nl = 3."""
    S, D, qm = _modal_problem(3, 128, "float32")
    want = np.asarray(pallas_spectral.fused_mm_solve(
        jnp.asarray(S), jnp.asarray(D), jnp.asarray(qm), interpret=True))
    args = [torch.as_tensor(a) for a in (S, D, qm)]
    got = fused_spectral.fused_mm_solve_reference(*args)
    assert got.dtype == torch.float32
    _close(got, want, 1e-4)
    before = fused_spectral.launches
    assert torch.equal(fused_spectral.fused_mm_solve(*args), got)
    assert fused_spectral.launches == before     # the CPU route counts none


@pytest.mark.parametrize("nl", [1, 3])
def test_fused_mm_build_solves_like_the_matmul_transform(nl):
    """build_spectral(fused_mm=True) on the CPU is the matmul solve: the
    same constants, and solve_spectral agrees with the JAX f64 solve."""
    kw = dict(nl=nl, N=128, L0=L0, dh=np.asarray(DH[:nl] if nl > 1 else
                                                 (1.0,)),
              s_profile=_sprof(nl), dtype=torch.float64, device="cpu",
              transform="matmul")
    fused = tspec.build_spectral(fused_mm=True, **kw)
    plain = tspec.build_spectral(**kw)
    assert fused.fused_mm and not plain.fused_mm
    assert torch.equal(fused.S, plain.S)
    assert torch.equal(fused.inv_den, plain.inv_den)
    j, _ = _build(nl, 128, "matmul")
    q = np.random.default_rng(nl).standard_normal((nl, 128, 128))
    got = tspec.solve_spectral(fused, torch.as_tensor(q))
    assert torch.equal(got, tspec.solve_spectral(plain, torch.as_tensor(q)))
    _close(got, jspec.solve_spectral(j, jnp.asarray(q)), 1e-12)


def test_build_constants_hands_fused_mm_on():
    cfg = QGConfig(N=128, nl=3, L0=L0, Rom=ROM, Fr=FR, dh=DH, beta=0.5,
                   dtype="float64", solver="spectral").validate()
    const = tqg.build_constants(cfg, device="cpu", fused_mm=True)
    assert const.spec.fused_mm and const.spec.S is not None
    assert const.spec.fac is None
    assert not tqg.build_constants(cfg, device="cpu").spec.fused_mm
    q = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (3, 128, 128)))
    psi, _ = tqg.invert_q(cfg, const, None, q)
    res = (tqg.comp_q(cfg, const, psi) - q).abs().max() / q.abs().max()
    assert res < 1e-12, float(res)


@pytest.mark.parametrize("N,dtype", [(64, torch.float32), (96, torch.float32),
                                     (192, torch.float32),
                                     (1152, torch.float32),
                                     (128, torch.float16)])
def test_fused_mm_size_gate_raises(N, dtype):
    """The TPU kernel's gate: f32 (the port also takes f64),
    128 <= N <= 1024, N % 128 == 0."""
    with pytest.raises(ValueError, match="fused_mm_solve"):
        fused_spectral.check_gate(dtype, N)
    with pytest.raises(ValueError, match="fused_mm_solve"):
        fused_spectral.fused_mm_solve(
            torch.zeros(N, N, dtype=dtype), torch.zeros(1, N, N, dtype=dtype),
            torch.zeros(1, N, N, dtype=dtype))
    if dtype == torch.float32:
        with pytest.raises(ValueError, match="fused_mm_solve"):
            tspec.build_spectral(nl=1, N=N, L0=1.0, dtype=dtype,
                                 transform="matmul", fused_mm=True,
                                 device="cpu")


def test_fused_mm_refuses_other_transforms_and_devices():
    with pytest.raises(ValueError, match="matmul"):
        tspec.build_spectral(nl=1, N=128, L0=1.0, dtype=torch.float32,
                             transform="auto", fused_mm=True, device="cpu")
    for N in (128, 1024):
        fused_spectral.check_gate(torch.float32, N)
        fused_spectral.check_gate(torch.float64, N)
    meta = [torch.empty(s, dtype=torch.float32, device="meta")
            for s in ((128, 128), (2, 128, 128), (2, 128, 128))]
    with pytest.raises(ValueError, match="device"):
        fused_spectral.fused_mm_solve(*meta)


def test_fused_spectral_bound_work_at_the_k7_path():
    """1024^2 x 4 f32: four products of 2 N^3 a layer, 34.4 GFLOP, against
    13 planes of 4 MB."""
    nbytes, nops = fused_spectral.bound_work(1024, 4, 4)
    assert nbytes == 13 * 1024 ** 2 * 4
    assert 4 * 4 * 2 * 1024 ** 3 <= nops < 4 * 4 * 2 * 1024 ** 3 * 1.001


def _rna_tf32(x: np.ndarray) -> np.ndarray:
    """float32 rounded to 10 explicit mantissa bits, to nearest with ties
    away from zero (cvt.rna.tf32.f32), by arithmetic in float64."""
    m, e = np.frexp(x.astype(np.float64))            # |m| in [0.5, 1)
    r = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5)
    return np.ldexp(r / 2.0 ** 11, e).astype(np.float32)


def _split_tf32(x: np.ndarray):
    hi = _rna_tf32(x)
    return hi, _rna_tf32((x - hi).astype(np.float32))


def test_basis_constants_are_the_split_of_s_and_its_transpose():
    """build_spectral(fused_mm=True) in float32 keeps the TF32 split of S
    and of S^T that K7 reads; its split is cvt.rna's rounding."""
    kw = dict(nl=3, N=128, L0=L0, dh=np.asarray(DH), s_profile=_sprof(3),
              dtype=torch.float32, device="cpu", transform="matmul")
    spec = tspec.build_spectral(fused_mm=True, **kw)
    S = spec.S.numpy()
    hi, lo = _split_tf32(S)
    mm = spec.mm
    np.testing.assert_array_equal(mm.S_hi.numpy(), hi)
    np.testing.assert_array_equal(mm.S_lo.numpy(), lo)
    np.testing.assert_array_equal(mm.St_hi.numpy(), hi.T)
    np.testing.assert_array_equal(mm.St_lo.numpy(), lo.T)
    for t in (mm.S_hi, mm.S_lo, mm.St_hi, mm.St_lo):
        assert t.is_contiguous()
        assert not (t.view(torch.int32) & 0x1FFF).any()   # 10 bits kept
    assert np.abs(hi.astype(np.float64) + lo - S).max() <= 2.0 ** -22
    # a tie rounds away from zero, and the package's split is the same
    ties = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11],
                    np.float32)
    np.testing.assert_array_equal(
        _rna_tf32(ties), [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1 + 2.0 ** -9])
    got = fused_spectral.tf32_split(torch.as_tensor(ties))
    np.testing.assert_array_equal(got[0].numpy(), _rna_tf32(ties))
    # float64 keeps no split: its kernel runs FP64 FMAs on S
    assert tspec.build_spectral(
        fused_mm=True, **{**kw, "dtype": torch.float64}).mm is None


@pytest.mark.parametrize("N,nl", [(128, 3), (256, 2)])
def test_three_pass_tf32_chain_is_as_close_as_fp32(N, nl):
    """K7's float32 arithmetic emulated: every product A B^T with A and B
    split to TF32 (hi + lo), hi.hi + hi.lo + lo.hi summed in float32, the
    chain of the kernel (transposed stores, D read transposed). Against
    the float64 chain on the same float32 inputs it stays within 1e-5 of
    max|psi_m| and within 4 times the FP32 chain's own error."""
    _, t = _build(nl, N, "matmul", "float32")
    S, D = t.S.numpy(), t.inv_den.numpy()
    qm = np.random.default_rng(N).standard_normal((nl, N, N)).astype(
        np.float32)

    def mm3(a, b):                       # a b^T, b the basis
        ah, al = _split_tf32(a)
        bh, bl = _split_tf32(b)
        f = [torch.as_tensor(x) for x in (ah, al, bh, bl)]
        return ((f[1] @ f[2].T + f[0] @ f[3].T) + f[0] @ f[2].T).numpy()

    St = np.ascontiguousarray(S.T)
    u1 = np.stack([mm3(q, S).T for q in qm])
    u2 = np.stack([mm3(u, S) * d.T for u, d in zip(u1, D)])
    u3 = np.stack([mm3(u, St).T for u in u2])
    got = np.stack([mm3(u, St) for u in u3])
    want = tspec._mm_solve(*(torch.as_tensor(a, dtype=torch.float64)
                             for a in (S, D, qm))).numpy()
    fp32 = tspec._mm_solve(*(torch.as_tensor(a) for a in (S, D, qm))).numpy()
    scale = np.abs(want).max()
    err = np.abs(got - want).max() / scale
    err32 = np.abs(fp32 - want).max() / scale
    assert err <= 1e-5 and err <= 4 * err32, (err, err32)
