"""ctypes bindings to the port's native host library, `basio.cpp` (the
port's own copy of `msom_tpu.native`): the .bas codec (`write_bas_native`,
`read_bas_native`, the same bytes as `io/bas.py`), a background-thread
snapshot writer (`AsyncBasWriter`) and a batched tridiagonal eigensolver
for the stretching matrix (`eig_tridiag_batch`).

The library builds with g++ at first use into
`build/native/libmsomnative-<hash>.so` at the root of the checkout, keyed
by a hash of the source and the command, as `_build.py` keys the CUDA
kernels: an edited source rebuilds, an unchanged one loads. The build
leaves out `-march=native`: a library tuned to one host's instruction set
can fault on another host that shares the `build/` directory. A failed
build raises with the compiler's output; nothing falls back silently. No
module of the port calls this library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from msom_tpu_torch.analysis import to_numpy

SOURCE = Path(__file__).resolve().parent / "basio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp", "-std=c++17")

_lib = None


def _target() -> Path:
    h = hashlib.sha256(" ".join(("g++",) + CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmsomnative-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("native: no g++ on the PATH to build basio.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("native: g++ failed for basio.cpp:\n"
                           + proc.stdout + proc.stderr)
    os.replace(tmp, out)      # atomic: a concurrent loader never sees half


def load() -> ctypes.CDLL:
    """The native library, built first if needed; raises if it cannot be
    built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    out = _target()
    if not out.exists():
        _build(out)
    lib = ctypes.CDLL(str(out))

    lib.bas_write.restype = ctypes.c_int
    lib.bas_write.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                              ctypes.c_int, ctypes.c_int, ctypes.c_double,
                              ctypes.c_double, ctypes.c_double]
    lib.bas_read.restype = ctypes.c_int
    lib.bas_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                             ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.bas_writer_create.restype = ctypes.c_void_p
    lib.bas_writer_submit.restype = ctypes.c_int
    lib.bas_writer_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double]
    lib.bas_writer_flush.restype = ctypes.c_int
    lib.bas_writer_flush.argtypes = [ctypes.c_void_p]
    lib.bas_writer_destroy.argtypes = [ctypes.c_void_p]
    lib.eig_tridiag_batch.restype = ctypes.c_int
    lib.eig_tridiag_batch.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]
    _lib = lib
    return lib


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _field32(field) -> np.ndarray:
    """A contiguous float32 (nl, n, n) host copy; a tensor comes to the
    host once."""
    f = np.ascontiguousarray(to_numpy(field), np.float32)
    return f[None] if f.ndim == 2 else f


def write_bas_native(path, field, L0, x0=0.0, y0=0.0):
    """Write an (n, n) or (nl, n, n) field as a .bas file."""
    f = _field32(field)
    nl, _, n = f.shape
    rc = load().bas_write(str(path).encode(), _fptr(f), nl, n, L0, x0, y0)
    if rc != 0:
        raise OSError(f"bas_write failed: {rc}")


def read_bas_native(path, nl_max=1000, n_hint=None):
    """Read up to nl_max layer blocks: (nl, n, n) float32."""
    if n_hint is None:
        with open(path, "rb") as fp:
            n_hint = int(np.fromfile(fp, np.float32, 1)[0])
    buf = np.empty((nl_max, n_hint, n_hint), np.float32)
    n_out = ctypes.c_int()
    nl = load().bas_read(str(path).encode(), _fptr(buf), nl_max,
                         ctypes.byref(n_out))
    if nl < 0:
        raise OSError(f"bas_read failed: {nl}")
    return np.array(buf[:nl])


class AsyncBasWriter:
    """Background-thread snapshot writer: `submit` copies the field and
    returns at once (the queue's depth); `flush` blocks until every file
    is on disk and returns the count of failed writes."""

    def __init__(self):
        self._lib = load()
        self._h = self._lib.bas_writer_create()

    def submit(self, path, field, L0, x0=0.0, y0=0.0):
        f = _field32(field)
        nl, _, n = f.shape
        return self._lib.bas_writer_submit(self._h, str(path).encode(),
                                           _fptr(f), nl, n, L0, x0, y0)

    def flush(self):
        return self._lib.bas_writer_flush(self._h)

    def close(self):
        if self._h:
            self._lib.bas_writer_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def eig_tridiag_batch(lower, diag, upper):
    """Batched tridiagonal eigensolve: inputs (nbatch, nl); returns
    (w ascending (nbatch, nl), vr (nbatch, nl, nl))."""
    lo = np.ascontiguousarray(lower, np.float64)
    di = np.ascontiguousarray(diag, np.float64)
    up = np.ascontiguousarray(upper, np.float64)
    nbatch, nl = di.shape
    w = np.empty((nbatch, nl), np.float64)
    vr = np.empty((nbatch, nl, nl), np.float64)
    rc = load().eig_tridiag_batch(_dptr(lo), _dptr(di), _dptr(up), nl,
                                  nbatch, _dptr(w), _dptr(vr))
    if rc != 0:
        raise RuntimeError("eig_tridiag_batch failed")
    return w, vr
