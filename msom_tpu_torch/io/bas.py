"""`.bas` gnuplot binary matrix I/O (the port's own copy of
`msom_tpu.io.bas`: the same bytes, pure numpy).

The reference's float32 layout (msqg/auxiliar_input.h:1-12, writer
:101-149), one block a layer:
    [N] [y_0 .. y_{N-1}] then for each x-row i: [x_i] [v(i,0) .. v(i,N-1)]
with v[i][j] the value at (x_i, y_j), i.e. the TRANSPOSE of the (y, x)
array convention. A layered field's blocks follow each other.
"""

from __future__ import annotations

import numpy as np


def write_bas(path_or_fp, field, L0: float, x0: float = 0.0, y0: float = 0.0):
    """Write a (ny, nx) or (nl, ny, nx) field; square grids only (the
    reference assumes the same)."""
    f = np.asarray(field, np.float64)
    if f.ndim == 2:
        f = f[None]
    nl, ny, nx = f.shape
    if ny != nx:
        raise ValueError("'.bas' format requires square fields")
    n = nx
    delta = L0 / n
    coords = (np.arange(n, dtype=np.float32) * delta
              + delta / 2).astype(np.float32)
    own = isinstance(path_or_fp, (str, bytes))
    fp = open(path_or_fp, "wb") if own else path_or_fp
    try:
        for l in range(nl):
            block = np.empty((n + 1, n + 1), np.float32)
            block[0, 0] = n
            block[0, 1:] = (coords + y0).astype(np.float32)
            block[1:, 0] = (coords + x0).astype(np.float32)
            block[1:, 1:] = f[l].T.astype(np.float32)  # v[i][j] = (x_i, y_j)
            block.tofile(fp)
    finally:
        if own:
            fp.close()


def read_bas(path_or_fp, nl: int | None = None):
    """Read layer blocks until the end of the file (or nl blocks). Returns
    (field, x, y), field (nl, n, n) in the (y, x) convention."""
    own = isinstance(path_or_fp, (str, bytes))
    fp = open(path_or_fp, "rb") if own else path_or_fp
    try:
        layers = []
        x = y = None
        while nl is None or len(layers) < nl:
            head = np.fromfile(fp, np.float32, 1)
            if head.size == 0:
                break
            n = int(head[0])
            y = np.fromfile(fp, np.float32, n)
            rows = np.fromfile(fp, np.float32, n * (n + 1))
            if rows.size < n * (n + 1):
                raise EOFError("truncated .bas block")
            rows = rows.reshape(n, n + 1)
            x = rows[:, 0]
            layers.append(rows[:, 1:].T.copy())  # back to (y, x)
        if not layers:
            raise EOFError("empty .bas file")
        return np.stack(layers), x, y
    finally:
        if own:
            fp.close()
