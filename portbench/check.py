"""The comparison that decides `correct`.

The program's run is checked call by call. An item is one call of the
driver: the program's state before it and after it. The plain reference
(float64) takes the state before, steps as many steps as the call should,
and the program's state after is compared with the reference's:

  q_err      max |q - q_ref| / max |q_ref|
  psi_err    max |psi - psi_ref| / max |psi_ref|
  t_err      the call's advance of the model time against the
             reference's, from the same time before the call:
             |(t - t0) - (t_ref - t0)| / |t_ref - t0|
  steps_off  |steps the call took - steps it should take|

Each number of a run is its largest over the items; a number that is not
finite reads inf. The first item is the first call of set-up, which the
reference follows from its own initial state, made from the same initial
field as the program's: that checks the start. The others are the calls
of the window that the seed drew; the reference follows them from the
program's own state, as far as one call reaches.

A cell's file gives the limit of each number it compares; the run is
correct where every compared number lies within its limit.
"""

from __future__ import annotations

import math

import torch


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.to(device=a.device, dtype=torch.float64)
    err = float((a - b).abs().amax())
    den = float(b.abs().amax())
    out = err / den if den > 0 else err
    return out if math.isfinite(out) else math.inf


def _advance_err(t, t_ref, t0: float) -> float:
    got = float(t) - t0
    want = float(t_ref) - t0
    out = abs(got - want) / abs(want) if want else abs(got - want)
    return out if math.isfinite(out) else math.inf


def compare(model, items, steps: int, psi0: torch.Tensor) -> list[dict]:
    """The numbers of each item. `items` are (before, after) snapshots,
    before None for the call from the initial state; `model` the
    reference."""
    out = []
    for before, after in items:
        if before is None:
            st = model.initial(psi0)
        else:
            st = model.from_program(before["q"], before["t"],
                                    before["dt_prev"], before["i"])
        i0, t0 = st.i, float(st.t)
        st = model.advance(st, steps)
        got = {"q_err": _rel(after["q"], st.q),
               "psi_err": _rel(after["psi"], st.psi),
               "t_err": _advance_err(after["t"], st.t, t0),
               "steps_off": abs(int(after["i"]) - i0 - steps)}
        out.append(got)
        del st
    return out


def judge(per_item: list[dict], limits: dict) -> tuple[int, dict]:
    """(items failed, {name: {"value", "limit"}}): for each number the cell
    compares, its largest over the items beside its limit."""
    shown = {k: {"value": max(it[k] for it in per_item), "limit": lim}
             for k, lim in limits.items()}
    failed = sum(any(it[k] > lim for k, lim in limits.items())
                 for it in per_item)
    return failed, shown
