"""Checkpoint and resume of the whole model state (the port of
`msom_tpu.io.checkpoint`).

Every non-None leaf of the state dataclass goes into one .npz, the CFL
controller's smoothing state and the filter mean included, so a resumed
run continues bit for bit. The port's stochastic step draws from a
torch.Generator instead of a state leaf: given one, `save_state` stores its
state (`generator`, a uint8 array) and `load_state` restores it, so a
restarted stochastic run continues the same stream. One process writes:
in a rows-sharded run the master, from the gathered state
(parallel/step.py `gather`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

GENERATOR_LEAF = "generator"


def save_state(path: str, state, generator: torch.Generator | None = None):
    leaves = {f.name: getattr(state, f.name).cpu().numpy()
              for f in dataclasses.fields(state)
              if getattr(state, f.name) is not None}
    if generator is not None:
        leaves[GENERATOR_LEAF] = generator.get_state().numpy()
    np.savez(path, **leaves)


def load_state(path: str, template, generator: torch.Generator | None = None):
    """Restore into the dataclass type of `template`, each leaf in the
    template's type and on its device (a leaf the template lacks goes to
    the device of its first leaf); leaves absent from the file keep the
    template's value. With `generator`, the file must hold a generator
    state, which it takes."""
    data = np.load(path)
    device = getattr(template, dataclasses.fields(template)[0].name).device
    kw = {}
    for f in dataclasses.fields(template):
        tv = getattr(template, f.name)
        if f.name not in data.files:
            kw[f.name] = tv
        elif tv is not None:
            kw[f.name] = torch.as_tensor(data[f.name], dtype=tv.dtype,
                                         device=tv.device)
        else:
            kw[f.name] = torch.as_tensor(data[f.name], device=device)
    if generator is not None:
        if GENERATOR_LEAF not in data.files:
            raise ValueError(f"{path} holds no generator state")
        generator.set_state(torch.from_numpy(data[GENERATOR_LEAF]))
    return dataclasses.replace(template, **kw)
