"""Seeded ``torch.Generator`` helpers (counterpart of ``paddle_tpu/core/generator.py``).

The JAX package keeps one global key and folds a counter into it. The
port never draws from torch's global RNG. The Paddle API (``seed``,
random creation ops, initializers, ``Dropout``) draws from one explicit
``torch.Generator`` per device (``default_generator``), all seeded by
``seed``; the torch-level models are handed generators made here from
an explicit seed. A JAX key and a torch generator never give the same
numbers from one seed, so tests that compare the two packages make their
inputs with numpy and copy weights across.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .place import DeviceLike, current_device


def make_generator(seed: int, device: DeviceLike = "cpu") -> torch.Generator:
    """A fresh generator on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    return g


def normal_(tensor: torch.Tensor, std: float,
            generator: torch.Generator) -> torch.Tensor:
    """In-place N(0, std) from ``generator``. The numbers are drawn on the
    generator's device and copied into ``tensor``, so one CPU generator
    gives the same weights whatever device the model lives on."""
    with torch.no_grad():
        draw = torch.empty(tensor.shape, dtype=torch.float32,
                           device=generator.device)
        draw.normal_(0.0, std, generator=generator)
        tensor.copy_(draw)
    return tensor


# ------------------------------------------------- the Paddle API's streams
_state: Dict[str, object] = {"seed": None, "generators": {}}


def seed(s: int) -> None:
    """paddle.seed: every device's generator restarts from ``s``."""
    _state["seed"] = int(s) & 0xFFFFFFFFFFFFFFFF
    for g in _state["generators"].values():
        g.manual_seed(_state["seed"])


def default_generator(device: DeviceLike = None) -> torch.Generator:
    """The Paddle API's generator of ``device`` (the current device by
    default), made on first use from the last ``seed`` (or a seed drawn
    from numpy's global RNG when none was set, as the JAX package does)."""
    dev = current_device() if device is None else torch.device(device)
    key = str(dev if dev.type == "cpu" or dev.index is not None
              else torch.device(dev.type, 0))
    g = _state["generators"].get(key)
    if g is None:
        if _state["seed"] is None:
            _state["seed"] = int(np.random.randint(0, 2 ** 31 - 1))
        g = make_generator(_state["seed"], key)
        _state["generators"][key] = g
    return g


def snapshot() -> Dict[str, torch.Tensor]:
    """The state of every Paddle-API generator made so far, by device."""
    return {k: g.get_state() for k, g in _state["generators"].items()}


def restore(states: Dict[str, torch.Tensor]) -> None:
    """Put the generators back to a ``snapshot``; one made since is
    dropped, so that its next use makes it afresh from the seed."""
    gens = _state["generators"]
    for k in list(gens):
        if k in states:
            gens[k].set_state(states[k])
        else:
            del gens[k]


def get_rng_state(generators: Optional[Sequence[torch.Generator]] = None
                  ) -> List[torch.Tensor]:
    """A snapshot of each generator's state, in order; with no argument,
    of the current device's Paddle-API generator (the JAX package
    snapshots its one global generator)."""
    if generators is None:
        generators = [default_generator()]
    return [g.get_state() for g in generators]


def set_rng_state(generators, states=None) -> None:
    """Put each generator back to its state from ``get_rng_state``:
    ``set_rng_state(generators, states)``, or ``set_rng_state(states)``
    for the current device's Paddle-API generator."""
    if states is None:
        generators, states = [default_generator()], generators
    if len(generators) != len(states):
        raise ValueError(f"set_rng_state: {len(states)} states for "
                         f"{len(generators)} generators")
    for g, st in zip(generators, states):
        g.set_state(st)
