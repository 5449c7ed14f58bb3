"""Model-parallel RNG streams (counterpart of
``paddle_tpu/distributed/fleet/mpu/random.py``; reference
fleet/meta_parallel/parallel_layers/random.py).

The tracker keeps named streams, each an explicit ``torch.Generator`` a
device made from its seed. ``rng_state(name)`` swaps the named stream
into the Paddle API's generator of the current device for a block
(dropout inside a tensor-parallel region draws from it) and keeps where
it got to; ``generator(name)`` hands the stream to a torch-level model.

Seeds are derived as the JAX package derives them, never with
``hash()`` (randomized per process): ``model_parallel_random_seed(seed)``
seeds the Paddle API with ``seed`` on every rank and adds the
model-parallel stream at ``seed + 1024`` — plus ``MP_SEED_STRIDE`` times
this rank's mp coordinate, so that mp ranks draw differently (their
shards hold different heads and columns) and dp ranks alike. A stream
used before it was added gets the JAX package's lazy seed,
``(base ^ adler32(name)) & 0x7FFFFFFF`` over the Paddle API's seed, plus
the same mp offset.
"""
from __future__ import annotations

import contextlib
import threading
import zlib
from typing import Optional

import torch

from ....core import generator as gen_mod
from ....core.place import current_device

MODEL_PARALLEL_RNG = "model_parallel_rng"
#: seed distance between neighbouring mp ranks' streams (the reference
#: offsets its local seed by 100 an mp rank)
MP_SEED_STRIDE = 100


def _mp_rank(hcg=None) -> int:
    if hcg is None:
        from ..base.topology import get_hybrid_communicate_group
        hcg = get_hybrid_communicate_group()
    return 0 if hcg is None else int(hcg.get_model_parallel_rank())


class RNGStatesTracker:
    def __init__(self):
        self._seeds = {}             # name -> seed
        self._generators = {}        # (name, device) -> torch.Generator
        self._lock = threading.Lock()

    def reset(self):
        with self._lock:
            self._seeds.clear()
            self._generators.clear()

    def seed_of(self, name: str = MODEL_PARALLEL_RNG) -> int:
        """The named stream's seed (derived lazily if it was not added)."""
        with self._lock:
            if name not in self._seeds:
                base = gen_mod._state["seed"] or 0
                tag = zlib.adler32(name.encode())
                self._seeds[name] = (((base ^ tag) & 0x7FFFFFFF)
                                     + MP_SEED_STRIDE * _mp_rank())
            return self._seeds[name]

    def get_states_tracker(self):
        with self._lock:
            return {k: g.get_state() for k, g in self._generators.items()}

    def set_states_tracker(self, states):
        with self._lock:
            for k, st in states.items():
                self._generators[k].set_state(st)

    def add(self, name: str, seed: int):
        with self._lock:
            if seed in self._seeds.values():
                raise ValueError(f"seed {seed} already exists")
            if name in self._seeds:
                raise ValueError(f"state {name} already exists")
            self._seeds[name] = int(seed)

    def generator(self, name: str = MODEL_PARALLEL_RNG,
                  device=None) -> torch.Generator:
        """The named stream on ``device`` (default: the current device)."""
        dev = torch.device(current_device() if device is None else device)
        seed = self.seed_of(name)
        key = (name, str(dev))
        with self._lock:
            if key not in self._generators:
                self._generators[key] = gen_mod.make_generator(seed, dev)
            return self._generators[key]

    @contextlib.contextmanager
    def rng_state(self, name: str = MODEL_PARALLEL_RNG):
        """Swap the named stream into the current device's Paddle-API
        generator for the block."""
        stream = self.generator(name)
        g = gen_mod.default_generator()
        orig = g.get_state()
        g.set_state(stream.get_state())
        try:
            yield
        finally:
            stream.set_state(g.get_state())
            g.set_state(orig)


_tracker = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _tracker


def model_parallel_random_seed(seed: int, hcg=None) -> Optional[int]:
    """Seed the Paddle API with ``seed`` and the model-parallel stream with
    ``seed + 1024 + MP_SEED_STRIDE * mp_rank``; returns the latter."""
    _tracker.reset()
    gen_mod.seed(seed)
    local = int(seed) + 1024 + MP_SEED_STRIDE * _mp_rank(hcg)
    _tracker.add(MODEL_PARALLEL_RNG, local)
    return local


def determinate_seed(name: str = MODEL_PARALLEL_RNG) -> int:
    return _tracker.seed_of(name)
