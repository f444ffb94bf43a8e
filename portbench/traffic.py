"""The general generator: reads a traffic mix (portbench/traffic/<name>.json)
and makes a run's inputs and its schedule of calls from the seed.

A mix's keys:
  dtype               the type the model runs in ("float32", "float64")
  ic                  the initial streamfunction: {"kind": "uniform",
                      "amplitude": a}, uniform noise in [-a, a] in every
                      layer and cell
  spinup_steps        steps from the initial state before the window, in
                      calls of steps_per_call
  warmup_calls        calls after the spin-up, before the window
  steps_per_call      the steps of every call of the driver
  replay_calls        the calls of one replay: the window runs them from
                      the state that set-up left, over and over, and ends
                      at the end of the first replay that finds `seconds`
                      passed; so every window does the same work a step,
                      however fast the program is
  samples             calls of the window that the comparison checks,
                      drawn from the seed
  trace_calls         calls of the traced window (--trace 1), the first
                      of a replay
"""

from __future__ import annotations

import random

import torch

KEYS = {"dtype", "ic", "spinup_steps", "warmup_calls", "steps_per_call",
        "replay_calls", "samples", "trace_calls"}


def check(mix: dict) -> dict:
    """The mix, or ValueError for a key that is missing or unknown."""
    if set(mix) != KEYS:
        raise ValueError(f"a traffic mix has the keys {sorted(KEYS)}, not "
                         f"{sorted(mix)}")
    if mix["ic"].get("kind") != "uniform":
        raise ValueError(f"unknown initial condition {mix['ic']!r}")
    if mix["spinup_steps"] % mix["steps_per_call"]:
        raise ValueError("spinup_steps is a whole number of calls")
    if not 1 <= mix["trace_calls"] <= mix["replay_calls"]:
        raise ValueError("trace_calls lies between 1 and replay_calls")
    return mix


def initial_field(mix: dict, shape, seed: int, device) -> torch.Tensor:
    """The initial streamfunction, drawn on the device in one call from a
    generator seeded with `seed`."""
    g = torch.Generator(device=device).manual_seed(seed)
    amp = float(mix["ic"]["amplitude"])
    dtype = getattr(torch, mix["dtype"])
    u = torch.rand(shape, generator=g, device=device, dtype=dtype)
    return amp * (2.0 * u - 1.0)


def calls_before_window(mix: dict) -> int:
    """The calls of set-up: the spin-up's and the warm-up's (at least
    one, so that the window finds every kernel built)."""
    return max(1, mix["spinup_steps"] // mix["steps_per_call"]
               + mix["warmup_calls"])


class Sampler:
    """Reservoir sampling of `k` calls out of a window whose length is not
    known in advance: every call of the window is as likely to be kept,
    and which are kept depends on the seed alone."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.kept: dict[int, object] = {}

    def offer(self, call: int) -> int | None:
        """The slot in which call number `call` (from 0) is kept, or
        None."""
        if call < self.k:
            return call
        j = self.rng.randrange(call + 1)
        return j if j < self.k else None

    def keep(self, slot: int, item) -> None:
        self.kept[slot] = item

    def items(self) -> list:
        return [self.kept[s] for s in sorted(self.kept)]
