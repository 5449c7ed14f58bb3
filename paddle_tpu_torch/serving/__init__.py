"""The serving tier's control plane (counterpart of ``paddle_tpu/serving``).

* :mod:`.scheduler`: the phase-split tick scheduler (chunked prefill
  under a per-tick token budget, decode every tick) and its per-phase
  accounting.
* :mod:`.speculative`: the n-gram draft proposer behind the engine's
  ``speculate=`` switch; the verify step itself is in the engine.

The JAX package's ``Router`` (multi-replica front door) and
``TokenStream`` (per-request incremental tokens) come with the next
slice, with the resilience layer they sit on.
"""
from .scheduler import Scheduler, SchedulerConfig
from .speculative import NgramProposer

__all__ = ["Scheduler", "SchedulerConfig", "NgramProposer"]
