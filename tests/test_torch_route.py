"""run_qg's routing of the sharded msqg run (msom_tpu_torch.parallel.step:
`route`, `rows_refusal`, `choose_mesh`) against the mode the JAX
package's run_qg records (run_qg.sharded_mode, msom_tpu/driver.py:
193-240) on its 8-device CPU mesh, at world sizes 1, 2, 4 and 8, with no
process group: the routing is a function of the configuration, its
constants and the world size. JAX's run_qg is called with tend = 0, so
it routes and places its state and takes no step.

* "auto" on the spectral and mg solvers at N = 64 and 128 (rows while
  (N / W) % 8 == 0), at N = 32 (the JAX kernels' tile gate, N >= 64),
  with mode_pv_invert, varRo, a frpg that varies in x (no kernel mode)
  and use_pallas=False: the port's mode equals JAX's;
* "rows" on a configuration that JAX's rows path does not take raises
  ValueError in both packages;
* choose_mesh: JAX's square mesh where it cuts N, else the squarest
  factorization that does, and ValueError where none does.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from msom_tpu import driver as jdriver
from msom_tpu.params import QGConfig as JConfig
from msom_tpu_torch.models import qg as tqg
from msom_tpu_torch.params import QGConfig as TConfig
from msom_tpu_torch.parallel import step as pstep

torch.set_num_threads(1)

BASE = dict(N=64, nl=3, L0=80, Rom=0.025, Ekb=0.002, tau0=1e-4, Re4=1563,
            beta=0.5, Fr=(0.0023669, 0.0076173), dh=(0.06, 0.14, 0.8),
            DT=5e-2, tend=0.0, dtout=1.0, CFL=0.6, dtype="float64",
            solver="spectral")
CONFIGS = {"spectral": {}, "mg": dict(solver="mg"),
           "spectral128": dict(N=128), "mg32": dict(N=32, solver="mg"),
           "modal": dict(solver="mg", mode_pv_invert=True),
           "varro": dict(varRo=1), "frpg2d": dict(solver="mg"),
           "nopallas": dict(solver="mg", use_pallas=False)}


def _frpg(kw):
    """A frpg that varies in x for the frpg2d case (no kernel mode)."""
    N = kw["N"]
    x = (np.arange(N) + 0.5) / N
    return np.stack([f * (1 + 0.1 * np.sin(2 * np.pi * x))[None, :]
                     * np.ones((N, 1)) for f in kw["Fr"]])


def _jax_mode(kw, world, sharded="auto", frpg=None):
    from msom_tpu.models import qg as jqg
    cfg = JConfig(**kw).validate()
    mesh = Mesh(np.array(jax.devices()[:world]).reshape(world, 1),
                ("y", "x"))
    const = None if frpg is None else jqg.build_constants(cfg, frpg=frpg)
    jdriver.run_qg(cfg, const=const, sharded=sharded, mesh=mesh)
    return jdriver.run_qg.sharded_mode


@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_auto_takes_the_mode_jax_records(name, world):
    kw = dict(BASE, **CONFIGS[name])
    frpg = _frpg(kw) if name == "frpg2d" else None
    cfg = TConfig(**kw).validate()
    const = tqg.build_constants(cfg, device="cpu",
                                **({} if frpg is None else dict(frpg=frpg)))
    got = pstep.route(cfg, world, const)
    assert got == _jax_mode(kw, world, frpg=frpg)
    assert (got == "rows") == (pstep.rows_refusal(cfg, world, const)
                               is None)


@pytest.mark.parametrize("name,world", [("spectral", 8), ("mg32", 2),
                                        ("modal", 1), ("varro", 2)])
def test_rows_where_jax_refuses_it_raises_value_error(name, world):
    kw = dict(BASE, **CONFIGS[name])
    if name == "spectral":
        kw["N"] = 32          # 4 rows a rank on 8 ranks
    cfg = TConfig(**kw).validate()
    with pytest.raises(ValueError, match="rows"):
        _jax_mode(kw, world, sharded="rows")
    with pytest.raises(ValueError, match="sharded='rows' does not take"):
        pstep.make_qg_step_sharded(cfg, device="cpu", mode="rows",
                                   mesh=(world, 1))


@pytest.mark.parametrize("over,world,want", [
    (dict(N=64), 8, (2, 4)),               # JAX's square mesh
    (dict(N=20), 4, (2, 2)),
    (dict(N=20), 8, (2, 4)),               # 20 % 4 == 0
    (dict(N=12), 8, (2, 4)),
    (dict(N=20), 3, None),                 # no factorization of 3 cuts 20
    (dict(N=18), 8, None),
    (dict(N=4, solver="mg"), 8, None),     # no tile of an even width
    (dict(N=4), 8, (2, 4)),                # tiles of 2 x 1
    (dict(N=16, solver="mg"), 8, (2, 4)),
    (dict(N=30), 6, (2, 3)),
    (dict(N=28), 6, None),
])
def test_choose_mesh(over, world, want):
    cfg = TConfig(**dict(BASE, **over)).validate()
    if want is None:
        with pytest.raises(ValueError, match="no factorization"):
            pstep.choose_mesh(cfg, world)
    else:
        assert pstep.choose_mesh(cfg, world) == want
