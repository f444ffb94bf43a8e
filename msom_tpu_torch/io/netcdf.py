"""NetCDF output and restart in the reference's layout (the port's own copy
of `msom_tpu.io.netcdf`: the same bytes, numpy and scipy).

qg-node writes (time, [level,] y, x) records of vertex fields on the
(N+1)^2 nodes (qg-node/netcdf_vertex_bas.h:53-172), newqg the cell-centred
(N, N) variant (newqg/netcdf_bas.h); restart reads a named variable at the
last stored time (netcdf_vertex_bas.h:315-424, `ncks -d time,-1,-1 vars.nc
restart.nc`). The format is NetCDF-3 classic, as the reference's nc_create
makes it, float32 on disk.

scipy's netcdf_file writes every record again whenever it flushes, so an
output event of the k-th record would write k records. `NCWriter` lets
scipy write the header, the coordinates and the first record, and then
appends: each later record is written once at the end of the file, and the
header's record count (bytes 4-7) is updated. The file is byte for byte the
one scipy writes after the same appends.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.io import netcdf_file


class NCWriter:
    """Append-mode record writer: create_nc and write_nc equivalents."""

    def __init__(self, path, var_names, n, nl=None, L0=1.0, x0=0.0, y0=0.0,
                 vertex=False, surface_vars=()):
        """`surface_vars`: names written without the level dimension even
        when nl is set (the SQG surface buoyancy bs, a 2-D field beside the
        layered ones, qg-node/qg.h:492-495)."""
        self.path = path
        self.names = list(var_names)
        npts = n + 1 if vertex else n
        f = netcdf_file(path, "w")
        f.createDimension("time", None)
        if nl is not None:
            f.createDimension("level", nl)
            f.createVariable("level", "i4", ("level",))[:] = np.arange(nl)
        f.createDimension("y", npts)
        f.createDimension("x", npts)
        delta = L0 / n
        coords = (np.arange(npts) * delta if vertex
                  else (np.arange(npts) + 0.5) * delta)
        f.createVariable("x", "f4", ("x",))[:] = coords + x0
        f.createVariable("y", "f4", ("y",))[:] = coords + y0
        f.createVariable("time", "f4", ("time",))
        dims = ("time", "level", "y", "x") if nl is not None else \
            ("time", "y", "x")
        # a record: time, then each field in the order defined, float32,
        # every size a multiple of 4 (so no padding)
        self._shapes = []
        for name in self.names:
            d = ("time", "y", "x") if name in surface_vars else dims
            f.createVariable(name, "f4", d)
            self._shapes.append((npts, npts) if len(d) == 3
                                else (nl, npts, npts))
        self._recsize = 4 + sum(4 * int(np.prod(s)) for s in self._shapes)
        self._f = f          # scipy's file until the first record is out
        self._begin = None   # offset of record 0
        self._nt = 0

    def _record(self, t, fields) -> list:
        out = [np.asarray(t, ">f4").reshape(())]
        for name, shape in zip(self.names, self._shapes):
            a = np.asarray(fields[name], np.float32)
            if a.size != int(np.prod(shape)):
                raise ValueError(f"{name} has shape {a.shape}, the file "
                                 f"holds {shape}")
            out.append(a.astype(">f4").reshape(shape))
        return out

    def append(self, t, **fields):
        rec = self._record(t, fields)
        if self._f is not None:
            f = self._f
            f.variables["time"][0] = rec[0]
            for name, a in zip(self.names, rec[1:]):
                f.variables[name][0] = a
            f.close()
            self._f = None
            self._begin = os.path.getsize(self.path) - self._recsize
        else:
            with open(self.path, "r+b") as fp:
                fp.seek(self._begin + self._nt * self._recsize)
                for a in rec:
                    fp.write(a.tobytes())
                fp.seek(4)
                fp.write(np.asarray(self._nt + 1, ">i4").tobytes())
        self._nt += 1

    def close(self):
        if self._f is not None:       # no record: the header alone
            self._f.close()
            self._f = None


def read_nc(path, names, time_index=-1):
    """Read variables at one time record (default the last, the
    reference's restart convention; time_index=None reads every record).
    Returns ({name: float64 array}, the record's time, or the array of
    times for None)."""
    with netcdf_file(path, "r", mmap=False) as f:
        out = {}
        for name in names:
            v = f.variables[name]
            out[name] = np.array(v[:] if time_index is None
                                 else v[time_index], np.float64)
        tv = f.variables["time"]
        t = (np.array(tv[:], np.float64) if time_index is None
             else float(np.array(tv[time_index])))
    return out, t
