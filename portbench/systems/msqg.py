"""The system under test for msqg configurations: the port's driver loop,
`msom_tpu_torch.driver.run_qg`, on one device.

This is the only file of the benchmark that the program's names reach
beyond the per-layer readers: it builds the port's QGConfig from the
configuration's keys and the traffic's type, its constants and initial
state, and drives run_qg in calls of a fixed number of steps. The helpers
below the driver (`bare_steps`, `invert`, `tendency`) call the layers under
run_qg alone, for the per-layer readers.
"""

from __future__ import annotations

import contextlib

import torch

from msom_tpu_torch import driver
from msom_tpu_torch.models import fused_rhs, qg
from msom_tpu_torch.params import QGConfig


class System:
    def __init__(self, keys: dict, dtype: str, device: str):
        kw = {k: tuple(v) if isinstance(v, list) else v
              for k, v in keys.items()}
        self.cfg = QGConfig(**kw, dtype=dtype).validate()
        self.device = device
        self.const = None
        self.mg_iters: list[int] | None = None

    def start(self, psi0: torch.Tensor):
        """Constants and the initial state from psi0."""
        self.const = qg.build_constants(self.cfg, device=self.device)
        return qg.init_state(self.cfg, self.const, psi0=psi0)

    def call(self, state, steps: int, done: int):
        """One call of run_qg that takes `steps` steps from step `done`."""
        state, _ = driver.run_qg(self.cfg, const=self.const, state=state,
                                 max_steps=done + steps, device=self.device)
        return state

    @staticmethod
    def steps_done(state) -> int:
        return int(state.i)

    @staticmethod
    def snapshot(state) -> dict:
        """Copies, on the device, of what the comparison reads."""
        return {"q": state.q.clone(), "psi": state.psi.clone(),
                "t": state.t.clone(), "dt_prev": state.dt_prev.clone(),
                "i": state.i.clone()}

    @contextlib.contextmanager
    def counting(self):
        """Within it, every step that run_qg makes records the V-cycles of
        its first inversion (StepDiag.mg_iters) in `mg_iters`."""
        self.mg_iters = []
        make_step = qg.make_step

        def counted(cfg, generator=None):
            step = make_step(cfg, generator)

            def wrapped(state, const, tnext):
                state, diag = step(state, const, tnext)
                self.mg_iters.append(diag.mg_iters)
                return state, diag
            return wrapped

        qg.make_step = counted
        try:
            yield
        finally:
            qg.make_step = make_step

    # -- the layers under run_qg, for the per-layer readers -----------------

    def bare_steps(self, state, steps: int):
        """`steps` steps of make_step's step launched back to back, towards
        the same event time run_qg gives it."""
        step = qg.make_step(self.cfg)
        for _ in range(steps):
            state, _ = step(state, self.const, self.cfg.tend)
        return state

    def invert(self, state):
        """One PV inversion of the state's q, from its psi."""
        return qg.invert_q(self.cfg, self.const, state.psi, state.q)

    def tendency(self, state):
        """One call of the tendency kernel K1 on the state's psi."""
        return fused_rhs.rhs_fused(self.cfg, self.const, state.psi)

    def release(self):
        self.const = None
