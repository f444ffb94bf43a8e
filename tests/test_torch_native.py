"""The port's native host library (msom_tpu_torch/native: basio.cpp built
with g++ at first use) against the port's own io/bas.py and ops/modes.py:
tests/test_native.py's three checks. Skips only where g++ is missing.

Tolerances: the .bas codec byte for byte and its read-back exactly; the
asynchronous writer's files read back exactly; the eigenvalues within
1e-9 of numpy's and the eigenvectors' residual below 1e-8 (QL iterations
against LAPACK)."""

import shutil

import numpy as np
import pytest
import torch

from msom_tpu_torch import native
from msom_tpu_torch.io.bas import read_bas, write_bas
from msom_tpu_torch.ops import modes

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ to build the native library")
RNG = np.random.default_rng(17)


def test_library_is_built_under_build_keyed_by_source():
    """load() builds into build/native/ under a name of the source's and
    the command's hash, and gives the same library on a second call."""
    lib = native.load()
    path = native._target()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("libmsomnative-")
    assert native.load() is lib


def test_codec_byte_identical(tmp_path):
    f = RNG.standard_normal((3, 32, 32)).astype(np.float32)
    p1 = str(tmp_path / "n.bas")
    p2 = str(tmp_path / "p.bas")
    native.write_bas_native(p1, f, L0=80.0)
    write_bas(p2, f, L0=80.0)
    assert open(p1, "rb").read() == open(p2, "rb").read()
    np.testing.assert_array_equal(native.read_bas_native(p1), f)
    # a 2-D field and a tensor take the same path
    native.write_bas_native(p1, torch.as_tensor(f[0]), L0=80.0, x0=1.0)
    write_bas(p2, f[0], L0=80.0, x0=1.0)
    assert open(p1, "rb").read() == open(p2, "rb").read()


def test_async_writer(tmp_path):
    f = RNG.standard_normal((2, 16, 16)).astype(np.float32)
    w = native.AsyncBasWriter()
    paths = [str(tmp_path / f"s{i}.bas") for i in range(8)]
    for p in paths:
        w.submit(p, f, 1.0)
    assert w.flush() == 0
    w.close()
    for p in paths:
        g, _, _ = read_bas(p)
        np.testing.assert_array_equal(g.astype(np.float32), f)


def test_eig_matches_numpy():
    dh = np.array([0.06, 0.14, 0.3, 0.5])
    s = np.abs(RNG.standard_normal((50, 3))) * 10
    A = modes.stretching_matrix(dh, s)
    nb, nl = 50, 4
    lo = np.zeros((nb, nl))
    di = np.zeros((nb, nl))
    up = np.zeros((nb, nl))
    for b in range(nb):
        for l in range(nl):
            di[b, l] = A[b, l, l]
            if l > 0:
                lo[b, l] = A[b, l, l - 1]
            if l < nl - 1:
                up[b, l] = A[b, l, l + 1]
    w, vr = native.eig_tridiag_batch(lo, di, up)
    w_np = np.sort(np.real(np.linalg.eigvals(A)), axis=-1)
    np.testing.assert_allclose(w, w_np, atol=1e-9)
    res = np.einsum("bij,bjm->bim", A, vr) - vr * w[:, None, :]
    assert np.abs(res).max() < 1e-8
