"""Seeded ``torch.Generator`` helpers (counterpart of ``paddle_tpu/core/generator.py``).

The JAX package keeps a global key and folds a counter into it. The port
keeps no global RNG state: every consumer is handed a generator made
here from an explicit seed. A JAX key and a torch generator never give
the same numbers from one seed, so tests that compare the two packages
make their inputs with numpy and copy weights across.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from .place import DeviceLike


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


def get_rng_state(generators: Sequence[torch.Generator]
                  ) -> List[torch.Tensor]:
    """A snapshot of each generator's state, in order (the JAX package
    snapshots its one global generator; the port has one per consumer)."""
    return [g.get_state() for g in generators]


def set_rng_state(generators: Sequence[torch.Generator],
                  states: Sequence[torch.Tensor]) -> None:
    """Put each generator back to its state from ``get_rng_state``."""
    if len(generators) != len(states):
        raise ValueError(f"set_rng_state: {len(states)} states for "
                         f"{len(generators)} generators")
    for g, st in zip(generators, states):
        g.set_state(st)
