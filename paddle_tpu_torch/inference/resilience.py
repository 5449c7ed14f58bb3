"""Serving-tier resilience primitives: statuses, SLOs, replica lifecycle
(counterpart of ``paddle_tpu/inference/resilience.py``).

The continuous-batching engine (``inference/serving.py``) is the data
plane; this module is its control-plane vocabulary:

* :class:`RequestStatus`: every submitted request ends in exactly one
  terminal status (``FINISHED/SHED/DEADLINE_MISSED/CANCELLED/FAILED``);
  overload, memory races, deadline expiry and injected faults are
  per-request outcomes, never exceptions out of the tick loop.
* :class:`Overloaded`: the one exception a *submitter* sees: explicit
  backpressure from the bounded admission queue (or a draining/stopped
  replica). Callers retry against another replica.
* :class:`ResilienceConfig`: the SLO knobs: queue bound, shed
  high-water mark, default TTFT/total deadlines.
* :class:`ReplicaLifecycle`: explicit replica states
  (``STARTING→WARMING→READY→DEGRADED→DRAINING→STOPPED``) with validated
  transitions and health/readiness probes, so a load balancer can stop
  routing to a stalled or draining replica without killing it.

Serving metric instruments (``paddle_tpu_serving_*``, the JAX package's
names) are declared here once; collection is gated by
``FLAGS_enable_metrics``.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from ..observability import metrics as _metrics

__all__ = ["RequestStatus", "TERMINAL_STATUSES", "Overloaded",
           "RequestOutcome", "ResilienceConfig", "ReplicaState",
           "ReplicaLifecycle"]


class RequestStatus:
    """String constants for the per-request state machine.

    ``QUEUED → RUNNING → FINISHED`` is the happy path; every other
    terminal is a degraded-but-accounted outcome. A request may bounce
    ``RUNNING → QUEUED`` under recompute preemption.
    """

    QUEUED = "QUEUED"                  # accepted, waiting for a slot
    RUNNING = "RUNNING"                # holds a slot and KV blocks
    FINISHED = "FINISHED"              # completed normally (eos / budget)
    SHED = "SHED"                      # dropped by overload shedding
    DEADLINE_MISSED = "DEADLINE_MISSED"  # TTFT or total deadline expired
    CANCELLED = "CANCELLED"            # caller cancel() or drain()
    FAILED = "FAILED"                  # never-fitting / tick crash


#: statuses a request can never leave
TERMINAL_STATUSES = frozenset({
    RequestStatus.FINISHED, RequestStatus.SHED,
    RequestStatus.DEADLINE_MISSED, RequestStatus.CANCELLED,
    RequestStatus.FAILED,
})


class Overloaded(RuntimeError):
    """Submit-time backpressure: the admission queue is full or the
    replica is draining/stopped. The request was NOT accepted — retry on
    another replica (or later)."""


@dataclass
class RequestOutcome:
    """Terminal record handed back for every submitted request."""

    rid: int
    status: str
    detail: str = ""
    tokens: List[int] = field(default_factory=list)
    submit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    token_times: List[float] = field(default_factory=list)

    @property
    def ttft(self) -> Optional[float]:
        if self.submit_t is None or self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def itls(self) -> List[float]:
        """Inter-token latencies (seconds) between consecutive tokens."""
        ts = self.token_times
        return [b - a for a, b in zip(ts, ts[1:])]


@dataclass
class ResilienceConfig:
    """SLO / overload knobs for one engine replica.

    ``max_queue``
        Bounded admission queue: ``add_request`` past this depth raises
        :class:`Overloaded` (explicit backpressure to the client).
    ``queue_high_water``
        Load-shedding threshold checked each tick: queued requests past
        this depth (newest first — they would wait longest) are marked
        ``SHED``. ``None`` disables shedding below the queue bound.
    ``default_ttft_deadline_s`` / ``default_deadline_s``
        Applied to requests submitted without explicit deadlines.
        ``None`` means unbounded.
    ``slo_target`` / ``slo_fast_window_s`` / ``slo_slow_window_s``
        The availability objective the deadlines serve and the two
        sliding windows behind the
        ``paddle_tpu_serving_slo_{fast,slow}_burn_rate`` gauges (SRE
        multiwindow pattern; see ``observability/reqtrace.py``). A
        terminal outcome other than FINISHED burns error budget.
    """

    max_queue: int = 256
    queue_high_water: Optional[int] = None
    default_ttft_deadline_s: Optional[float] = None
    default_deadline_s: Optional[float] = None
    slo_target: float = 0.99
    slo_fast_window_s: float = 60.0
    slo_slow_window_s: float = 600.0

    def __post_init__(self):
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if (self.queue_high_water is not None
                and not 0 <= self.queue_high_water <= self.max_queue):
            raise ValueError(
                f"queue_high_water must be in [0, max_queue="
                f"{self.max_queue}]")
        if not 0.0 < self.slo_target < 1.0:
            raise ValueError("slo_target must be in (0, 1)")
        if not 0.0 < self.slo_fast_window_s <= self.slo_slow_window_s:
            raise ValueError(
                "need 0 < slo_fast_window_s <= slo_slow_window_s")


class ReplicaState:
    """Replica lifecycle states (ordinal order = the normal progression;
    the gauge exports the ordinal)."""

    STARTING = "STARTING"    # constructed, no request served yet
    WARMING = "WARMING"      # warmup request running prefill/decode
    READY = "READY"          # serving, readiness probe green
    DEGRADED = "DEGRADED"    # serving, but a tick stalled/crashed —
    #                          readiness red so the LB drains traffic away
    DRAINING = "DRAINING"    # admission closed, finishing in-flight work
    STOPPED = "STOPPED"      # drained; liveness red

    ORDER = (STARTING, WARMING, READY, DEGRADED, DRAINING, STOPPED)


_ALLOWED_TRANSITIONS = {
    ReplicaState.STARTING: {ReplicaState.WARMING, ReplicaState.READY,
                            ReplicaState.DEGRADED,   # first tick can crash
                            ReplicaState.DRAINING, ReplicaState.STOPPED},
    ReplicaState.WARMING: {ReplicaState.READY, ReplicaState.DEGRADED,
                           ReplicaState.DRAINING, ReplicaState.STOPPED},
    ReplicaState.READY: {ReplicaState.DEGRADED, ReplicaState.DRAINING,
                         ReplicaState.STOPPED},
    ReplicaState.DEGRADED: {ReplicaState.READY, ReplicaState.DRAINING,
                            ReplicaState.STOPPED},
    ReplicaState.DRAINING: {ReplicaState.STOPPED},
    ReplicaState.STOPPED: set(),
}

#: states in which new submissions are accepted (queueing before READY is
#: fine — they wait for the warmup request only)
_ADMITTING = frozenset({ReplicaState.STARTING, ReplicaState.WARMING,
                        ReplicaState.READY, ReplicaState.DEGRADED})


#: default replica-name ordinals (stable within one process)
_REPLICA_COUNTER = itertools.count(0)


class ReplicaLifecycle:
    """Validated replica state machine + probes.

    Thread-safe: the watchdog flips ``DEGRADED`` from its poll thread
    while the tick loop runs. Invalid transitions raise — a replica that
    silently resurrects from ``STOPPED`` is a routing bug.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 name: Optional[str] = None):
        self._clock = clock
        self._lock = threading.Lock()
        self.state = ReplicaState.STARTING
        #: stable per-replica metric label — several engines in one
        #: process (multi-replica serving) must not clobber each
        #: other's probe gauges
        self.name = name if name is not None else \
            f"replica{next(_REPLICA_COUNTER)}"
        self.history: List[Tuple[float, str, str]] = []  # (t, state, why)
        self._export_state()

    def _export_state(self, prev: Optional[str] = None):
        """Metrics on every transition: state ordinal + the probe
        results (what /readyz and /livez would answer right now) + a
        labeled transition counter, so a router/dashboard can follow a
        replica without polling health(). The probe gauges are labeled
        per replica; the state ordinal gauge is unlabeled,
        last-writer-wins, as in the JAX package."""
        M_REPLICA_STATE.set(ReplicaState.ORDER.index(self.state))
        M_REPLICA_READY.set(1.0 if self.state == ReplicaState.READY
                            else 0.0, replica=self.name)
        M_REPLICA_LIVE.set(0.0 if self.state == ReplicaState.STOPPED
                           else 1.0, replica=self.name)
        if prev is not None:
            M_REPLICA_TRANSITIONS.inc(from_state=prev,
                                      to_state=self.state)

    def to(self, state: str, reason: str = "") -> str:
        with self._lock:
            if state == self.state:
                return self.state
            if state not in _ALLOWED_TRANSITIONS[self.state]:
                raise RuntimeError(
                    f"invalid replica transition {self.state} -> {state}"
                    + (f" ({reason})" if reason else ""))
            prev = self.state
            self.state = state
            self.history.append((self._clock(), state, reason))
            self._export_state(prev)
            return state

    # ------------------------------------------------------------- probes
    def ready(self) -> bool:
        """Readiness: should the load balancer route NEW traffic here."""
        return self.state == ReplicaState.READY

    def live(self) -> bool:
        """Liveness: the replica process is worth keeping."""
        return self.state != ReplicaState.STOPPED

    def admitting(self) -> bool:
        return self.state in _ADMITTING

    def degrade(self, reason: str = ""):
        """Best-effort flip to DEGRADED (no-op once draining/stopped) —
        the watchdog path must never raise from its poll thread."""
        with self._lock:
            if ReplicaState.DEGRADED in _ALLOWED_TRANSITIONS[self.state]:
                prev = self.state
                self.state = ReplicaState.DEGRADED
                self.history.append(
                    (self._clock(), ReplicaState.DEGRADED, reason))
                self._export_state(prev)


# --------------------------------------------------------------------------
# Serving metric instruments (the JAX package's names). Declared once at
# import; recording is FLAGS_enable_metrics gated at dict-lookup cost.
# --------------------------------------------------------------------------
M_QUEUE_DEPTH = _metrics.gauge(
    "paddle_tpu_serving_queue_depth",
    "Requests waiting in the admission queue (sampled each tick and on "
    "submit).")
M_ADMITTED = _metrics.counter(
    "paddle_tpu_serving_admitted",
    "Requests admitted into a decode slot (re-admissions after "
    "preemption count again).")
M_SHED = _metrics.counter(
    "paddle_tpu_serving_shed",
    "Queued requests dropped by overload shedding past "
    "queue_high_water.")
M_DEADLINE_MISSED = _metrics.counter(
    "paddle_tpu_serving_deadline_missed",
    "Requests cancelled because their TTFT or total deadline expired.")
M_EVICTIONS = _metrics.counter(
    "paddle_tpu_serving_evictions",
    "Recompute preemptions: a running request evicted to free KV blocks "
    "and requeued.")
M_TTFT = _metrics.histogram(
    "paddle_tpu_serving_ttft_seconds",
    "Time from submit to first generated token.")
M_ITL = _metrics.histogram(
    "paddle_tpu_serving_itl_seconds",
    "Inter-token latency between consecutive generated tokens of one "
    "request.")
M_KV_BLOCKS = _metrics.gauge(
    "paddle_tpu_serving_kv_blocks_in_use",
    "Physical KV-cache blocks currently allocated to requests.")
M_KV_BYTES_PER_TOKEN = _metrics.gauge(
    "paddle_tpu_serving_kv_bytes_per_token",
    "Resident KV bytes one cached token costs across all layers "
    "(int8 page pools roughly halve this vs bf16 — the resident-batch "
    "multiplier).")
M_REQUESTS = _metrics.counter(
    "paddle_tpu_serving_requests",
    "Requests reaching a terminal status, by outcome.",
    labelnames=("outcome",))
M_TICK_SECONDS = _metrics.histogram(
    "paddle_tpu_serving_tick_seconds",
    "Wall time of one engine tick (admit + prefill + batched decode).")
M_TICK_FAILURES = _metrics.counter(
    "paddle_tpu_serving_tick_failures",
    "Engine ticks that raised internally; the tick loop absorbed the "
    "error, failed the in-flight requests and degraded the replica.")
M_REPLICA_STATE = _metrics.gauge(
    "paddle_tpu_serving_replica_state",
    "Replica lifecycle state ordinal: 0=STARTING 1=WARMING 2=READY "
    "3=DEGRADED 4=DRAINING 5=STOPPED.")
M_REPLICA_READY = _metrics.gauge(
    "paddle_tpu_serving_replica_ready",
    "Readiness probe as a metric (1 = route new traffic here), updated "
    "on every lifecycle transition, per replica.",
    labelnames=("replica",))
M_REPLICA_LIVE = _metrics.gauge(
    "paddle_tpu_serving_replica_live",
    "Liveness probe as a metric (0 = STOPPED), updated on every "
    "lifecycle transition, per replica.", labelnames=("replica",))
M_REPLICA_TRANSITIONS = _metrics.counter(
    "paddle_tpu_serving_replica_transitions_total",
    "Replica lifecycle transitions, by (from_state, to_state).",
    labelnames=("from_state", "to_state"))
