"""The serving tier's control plane (counterpart of ``paddle_tpu/serving``).

* :mod:`.scheduler`: the phase-split tick scheduler (chunked prefill
  under a per-tick token budget, decode every tick) and its per-phase
  accounting.
* :mod:`.speculative`: the n-gram draft proposer behind the engine's
  ``speculate=`` switch; the verify step itself is in the engine.
* :mod:`.stream`: per-request incremental token streams
  (``engine.stream(rid)`` / ``router.stream(rid)``).
* :mod:`.router`: the multi-replica front door: admission keyed on the
  replicas' readiness probes, queue-depth load balancing, ``Overloaded``
  retry on the next replica, re-routing of requests stranded by a
  degraded or drained replica, and shedding at the router.

Every layer stamps the request flight recorder
(``observability/reqtrace.py``): router decisions, the engine's
admission, chunk scheduling, decode ticks and preemptions, and stream
delivery marks land on one per-request timeline.
"""
from .router import Router, RouterConfig
from .scheduler import Scheduler, SchedulerConfig
from .speculative import NgramProposer
from .stream import TokenStream

__all__ = ["Router", "RouterConfig", "Scheduler", "SchedulerConfig",
           "NgramProposer", "TokenStream"]
