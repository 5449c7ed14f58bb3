"""Request flight recorder: per-request lifecycle timelines for serving
(counterpart of ``paddle_tpu/observability/reqtrace.py``).

Aggregate counters say how many requests missed their deadline;
reconstructing why one request took 900 ms needs its causal timeline:
which queue it waited in, which prefill chunks it got, which tick
preempted it, which replica it was re-routed to. Every state transition
of every request is stamped into a per-request event list with the
producer's clock and cause metadata, in a stable event vocabulary:

``submitted -> routed(replica) -> queued -> admitted ->
prefill_chunk(chunk, tokens) -> first_token -> decode_tick(tick) /
spec_verify(proposed, accepted) -> preempted(victim_reason) /
rerouted(from, tokens_carried) -> terminal(outcome)``

plus post-terminal stream-delivery marks (``first_delivery`` /
``stream_closed``). Producers: ``inference/serving.py``,
``serving/router.py`` and ``serving/stream.py``. Scopes are replica
names (``engine.lifecycle.name``) or a router's ``name``; a router
timeline joins its replica timelines through the ``routed`` events'
``replica``/``replica_rid`` metadata (:func:`stitch`).

Derived accounting on top of the raw events:

* :func:`segments`: exact decomposition of a request's wall time into
  ``queue / prefill / decode / preempted / rerouted`` (every
  inter-event interval is attributed to exactly one bucket, so they sum
  to submit -> terminal);
* :class:`ExemplarStore`: the worst-k TTFT/ITL observations keep their
  request id, so "p99 regressed" resolves to a concrete timeline;
* :class:`SloTracker`: multiwindow burn-rate gauges
  (``paddle_tpu_serving_slo_{fast,slow}_burn_rate``): the fraction of
  requests in a sliding window that ended other than ``FINISHED``,
  divided by the error budget ``1 - slo_target``.

Recording is gated by ``FLAGS_reqtrace`` (default on). The disabled path
reads no clock: call sites check :func:`enabled` before touching a
timestamp. ``PADDLE_TPU_REQTRACE=/path`` persists the rings
(rank-suffixed) at process exit and from the watchdog's hang path.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..core import flags
from . import metrics as _metrics
from .flight import rank_world

__all__ = ["RequestTraceRecorder", "RECORDER", "enabled", "record",
           "segments", "validate", "stitch", "ExemplarStore", "EXEMPLARS",
           "SloTracker", "dump", "load_dump", "record_path", "RECORD_ENV",
           "RETAINED", "MAX_EVENTS_PER_REQUEST", "SEGMENT_BUCKETS",
           "EVENTS"]

flags.define_flag(
    "reqtrace", True,
    "Record every serving request's lifecycle transitions (submit, "
    "admit, prefill chunks, decode ticks, preemption, re-route, "
    "terminal) into bounded per-request timelines for post-hoc tail "
    "latency diagnosis.")

_enabled = {"on": bool(flags.get_flag("reqtrace"))}
flags.on_change("reqtrace",
                lambda v: _enabled.__setitem__("on", bool(v)))


def enabled() -> bool:
    return _enabled["on"]


#: env var naming the persistence path (rank-suffixed per process)
RECORD_ENV = "PADDLE_TPU_REQTRACE"

#: terminal timelines retained in the ring (newest win; older evicted)
RETAINED = 512

#: events one timeline may hold — a runaway generation degrades to a
#: counted drop, never unbounded memory
MAX_EVENTS_PER_REQUEST = 4096

#: total events the done-ring may retain across all timelines (long
#: generations hold thousands of decode_tick events each; the ring must
#: stay MB-scale like trace.MAX_EVENTS, not grow with token budgets)
MAX_RETAINED_EVENTS = 100_000

#: the stable event vocabulary (the JAX package's)
EVENTS = ("submitted", "routed", "queued", "admitted", "prefill_chunk",
          "prefill_deferred", "first_token", "decode_tick", "spec_verify",
          "preempted", "rerouted", "shed", "terminal", "first_delivery",
          "stream_closed")

#: marks that may legally land AFTER the terminal event (client-side
#: stream delivery happens after the engine finishes the request)
POST_TERMINAL_EVENTS = frozenset({"first_delivery", "stream_closed"})

#: the exact wall decomposition buckets (sum to submit→terminal)
SEGMENT_BUCKETS = ("queue", "prefill", "decode", "preempted", "rerouted")

M_EVICTED = _metrics.counter(
    "paddle_tpu_reqtrace_evicted_total",
    "Terminal request timelines evicted from the bounded reqtrace ring "
    "(oldest first) — raise RETAINED if post-hoc diagnosis needs more.")
M_DROPPED = _metrics.counter(
    "paddle_tpu_reqtrace_dropped_events_total",
    "Events dropped because one request's timeline hit "
    "MAX_EVENTS_PER_REQUEST.")
M_SLO_FAST_BURN = _metrics.gauge(
    "paddle_tpu_serving_slo_fast_burn_rate",
    "SLO error-budget burn rate over the FAST sliding window "
    "(bad-outcome fraction / (1 - slo_target)); >1 means the budget is "
    "burning faster than sustainable — a shed storm shows here in "
    "seconds.", labelnames=("scope",))
M_SLO_SLOW_BURN = _metrics.gauge(
    "paddle_tpu_serving_slo_slow_burn_rate",
    "SLO error-budget burn rate over the SLOW sliding window — the "
    "multiwindow partner of the fast gauge (alert when BOTH exceed "
    "their thresholds, per the SRE multiwindow/multi-burn-rate "
    "pattern).", labelnames=("scope",))


class RequestTraceRecorder:
    """Bounded per-request timeline store.

    Live (non-terminal) timelines are keyed by ``(scope, rid)``; a
    ``terminal`` event moves the timeline into a bounded done-ring where
    it stays inspectable (and joinable by :func:`stitch`) until evicted
    by newer terminals. Thread-safe: the watchdog reads tails from its
    poll thread while the tick loop appends.
    """

    def __init__(self, retain: int = RETAINED,
                 max_events: int = MAX_EVENTS_PER_REQUEST,
                 max_retained_events: int = MAX_RETAINED_EVENTS):
        self._lock = threading.Lock()
        self._live: "collections.OrderedDict[Tuple[str, int], dict]" = \
            collections.OrderedDict()
        self._done: "collections.deque[dict]" = collections.deque()
        self._done_index: Dict[Tuple[str, int], dict] = {}
        self._retain = retain
        self._max_events = max_events
        self._max_retained_events = max_retained_events
        self._done_events = 0
        self.evicted = 0

    # ------------------------------------------------------------ record
    def event(self, scope: str, rid: int, event: str, t: float,
              meta: Optional[dict] = None):
        """Append one lifecycle event. ``t`` is the producer's clock
        (the engine/router clock seam, so FakeClock tests stay
        deterministic) — the recorder itself never reads a clock."""
        key = (str(scope), int(rid))
        with self._lock:
            tl = self._live.get(key)
            if event in POST_TERMINAL_EVENTS:
                # delivery marks are SINGULAR per request (re-attaching
                # a second stream must not restamp first_delivery with
                # a later timestamp) and may land after terminal —
                # attach to the finished timeline, never open a ghost
                target = tl if tl is not None \
                    else self._done_index.get(key)
                if target is None or any(
                        e["event"] == event for e in target["events"]):
                    return
                if (self._append(target, event, t, meta)
                        and target is not tl):
                    self._done_events += 1
                    self._evict_done_locked()
                return
            if tl is None:
                if key in self._done_index:
                    return       # lifecycle event after terminal: drop
                tl = self._live[key] = {
                    "scope": key[0], "rid": key[1], "events": [],
                    "dropped": 0}
                # bound the live side too: an abandoned producer must
                # not grow the map forever (terminal normally clears it)
                while len(self._live) > 4 * self._retain:
                    self._live.popitem(last=False)
                    self.evicted += 1
                    M_EVICTED.inc()
            self._append(tl, event, t, meta)
            if event == "terminal":
                self._live.pop(key, None)
                self._done.append(tl)
                self._done_index[key] = tl
                self._done_events += len(tl["events"])
                self._evict_done_locked()

    def _evict_done_locked(self):
        """Trim the done ring to its count AND total-event budgets."""
        while (len(self._done) > self._retain
               or (self._done_events > self._max_retained_events
                   and len(self._done) > 1)):
            old = self._done.popleft()
            self._done_index.pop((old["scope"], old["rid"]), None)
            self._done_events -= len(old["events"])
            self.evicted += 1
            M_EVICTED.inc()

    def _append(self, tl: dict, event: str, t: float,
                meta: Optional[dict]) -> bool:
        if len(tl["events"]) >= self._max_events:
            tl["dropped"] += 1
            M_DROPPED.inc()
            return False
        rec = {"event": event, "t": float(t)}
        if meta:
            rec["meta"] = meta
        tl["events"].append(rec)
        return True

    # ----------------------------------------------------------- inspect
    def timeline(self, scope: str, rid: int) -> Optional[dict]:
        """Copy of one request's timeline (live or retained terminal);
        None when unknown/evicted."""
        key = (str(scope), int(rid))
        with self._lock:
            tl = self._live.get(key) or self._done_index.get(key)
            return _copy_tl(tl) if tl is not None else None

    def tail(self, n: int = 0) -> List[dict]:
        """Newest ``n`` TERMINAL timelines (all when n<=0) as JSON-able
        copies (what a dump and the watchdog carry)."""
        with self._lock:
            done = list(self._done)
        return [_copy_tl(t) for t in (done[-n:] if n > 0 else done)]

    def live_timelines(self) -> List[dict]:
        """Copies of every non-terminal timeline (hang diagnosis: the
        requests stuck mid-flight when the tick loop wedged)."""
        with self._lock:
            return [_copy_tl(t) for t in self._live.values()]

    def clear(self):
        with self._lock:
            self._live.clear()
            self._done.clear()
            self._done_index.clear()
            self._done_events = 0
            self.evicted = 0


def _copy_tl(tl: dict) -> dict:
    out = dict(tl)
    out["events"] = [dict(e) for e in tl["events"]]
    return out


#: process-global recorder the serving layer stamps into
RECORDER = RequestTraceRecorder()

#: module clock seam — read ONLY when a caller records without its own
#: timestamp AND the flag is on (tests monkeypatch this to prove the
#: disabled path is clock-free)
_now = time.monotonic


def record(scope: str, rid: int, event: str, t: Optional[float] = None,
           **meta):
    """Convenience producer API: no-op (zero clock reads) when
    ``FLAGS_reqtrace`` is off."""
    if not _enabled["on"]:
        return
    RECORDER.event(scope, rid, event, _now() if t is None else t,
                   meta or None)


def emit(scope: str, clock: Callable[[], float], rid: int, event: str,
         t: Optional[float] = None, **meta):
    """The one producer path behind the engine's and router's
    ``_rt_event`` helpers: enabled-gate first (the disabled path reads
    NO clock), then stamp with the producer's clock seam so FakeClock
    drills stay deterministic."""
    if not _enabled["on"]:
        return
    RECORDER.event(scope, rid, event, clock() if t is None else t,
                   meta or None)


# ---------------------------------------------------------------------------
# Derived accounting: exact wall-segment decomposition
# ---------------------------------------------------------------------------
#: event -> the attribution state that STARTS at it (time between two
#: events is billed to the state entered at the first one)
_STATE_AFTER = {
    "submitted": "queue", "queued": "queue", "routed": "queue",
    "shed": "queue",
    "admitted": "prefill", "prefill_chunk": "prefill",
    "prefill_deferred": "prefill",
    "first_token": "decode", "decode_tick": "decode",
    "spec_verify": "decode",
    "preempted": "preempted",
    "rerouted": "rerouted",
}


def segment_intervals(timeline: dict
                      ) -> Tuple[List[Tuple[str, float, float]], bool]:
    """``([(state, t0, t1), ...], complete)`` — the lifecycle-state
    intervals behind :func:`segments` (and the chrome-trace lanes in
    ``tools/request_trace.py``). Every inter-event interval is
    attributed to exactly one state, so the intervals tile
    submit→terminal with no gaps or overlaps."""
    evs = [e for e in timeline.get("events", ())
           if e["event"] not in POST_TERMINAL_EVENTS]
    if not evs:
        return [], False
    terminals = [i for i, e in enumerate(evs) if e["event"] == "terminal"]
    last = terminals[-1] if terminals else None
    out: List[Tuple[str, float, float]] = []
    complete = False
    state = "queue"
    prev_t = evs[0]["t"]
    for i, e in enumerate(evs):
        if e["t"] > prev_t:
            if out and out[-1][0] == state and out[-1][2] == prev_t:
                out[-1] = (state, out[-1][1], e["t"])
            else:
                out.append((state, prev_t, e["t"]))
        prev_t = e["t"]
        if e["event"] == "terminal":
            if i == last:
                complete = True
                break
            # a non-final terminal only appears in stitched router
            # timelines: a STRANDING outcome leaves the request between
            # replicas (rerouted) until its next admission; a replica
            # FINISHED terminal just awaits router settle — that gap
            # stays billed to the state the request finished in
            if (e.get("meta") or {}).get("outcome") != "FINISHED":
                state = "rerouted"
        else:
            state = _STATE_AFTER.get(e["event"], state)
    return out, complete


def segments(timeline: dict) -> dict:
    """Exact decomposition of one request's wall time into
    ``queue / prefill / decode / preempted / rerouted`` seconds.

    Sums the :func:`segment_intervals` attribution, so the buckets sum
    to ``terminal.t - submitted.t`` exactly (floating addition aside).

    Returns ``{"queue":s, "prefill":s, "decode":s, "preempted":s,
    "rerouted":s, "total":s, "complete":bool}`` (``complete`` False for
    a live/torn timeline — no terminal yet)."""
    out = {b: 0.0 for b in SEGMENT_BUCKETS}
    intervals, complete = segment_intervals(timeline)
    out["total"] = 0.0
    out["complete"] = complete
    for state, t0, t1 in intervals:
        out[state] += t1 - t0
    evs = [e for e in timeline.get("events", ())
           if e["event"] not in POST_TERMINAL_EVENTS]
    if evs:
        terms = [e for e in evs if e["event"] == "terminal"]
        out["total"] = (terms[-1]["t"] if terms
                        else evs[-1]["t"]) - evs[0]["t"]
    return out


def validate(timeline: dict) -> List[str]:
    """Completeness problems of one timeline (empty list = complete):
    starts at ``submitted``, timestamps monotonic, exactly one final
    ``terminal`` with nothing but stream marks after it, and the
    segment buckets sum to the total wall time."""
    problems: List[str] = []
    evs = timeline.get("events", ())
    if not evs:
        return ["empty timeline"]
    if evs[0]["event"] != "submitted":
        problems.append(f"starts with {evs[0]['event']!r}, not "
                        f"'submitted'")
    core = [e for e in evs if e["event"] not in POST_TERMINAL_EVENTS]
    for a, b in zip(core, core[1:]):
        if b["t"] < a["t"]:
            problems.append(
                f"non-monotonic: {b['event']}@{b['t']} after "
                f"{a['event']}@{a['t']}")
            break
    terms = [i for i, e in enumerate(core) if e["event"] == "terminal"]
    if not terms:
        problems.append("no terminal event (unclosed timeline)")
    elif terms[-1] != len(core) - 1:
        problems.append("lifecycle events after the final terminal")
    if timeline.get("dropped"):
        problems.append(f"{timeline['dropped']} events dropped (ring "
                        f"bound)")
    if not problems:
        seg = segments(timeline)
        covered = sum(seg[b] for b in SEGMENT_BUCKETS)
        if abs(covered - seg["total"]) > 1e-6 + 1e-9 * abs(seg["total"]):
            problems.append(
                f"segments sum {covered} != total {seg['total']}")
    return problems


def stitch(router_timeline: dict,
           lookup: Optional[Callable[[str, int], Optional[dict]]] = None
           ) -> dict:
    """Join a router-scope timeline with its replica-side legs into ONE
    causal timeline: for every ``routed`` event carrying
    ``replica``/``replica_rid`` metadata, the replica timeline's events
    are merged in (tagged with their replica scope), sorted by
    timestamp. Replica-level terminals that stranded the request stay
    in the merged list — :func:`segments` bills the gap to the
    ``rerouted`` bucket. ``lookup`` defaults to the process recorder."""
    lookup = lookup or RECORDER.timeline
    merged = []
    for e in router_timeline.get("events", ()):
        rec = dict(e)
        rec["scope"] = router_timeline.get("scope")
        merged.append(rec)
    final_t = None
    terms = [e for e in router_timeline.get("events", ())
             if e["event"] == "terminal"]
    if terms:
        final_t = terms[-1]["t"]
    for e in router_timeline.get("events", ()):
        if e["event"] != "routed":
            continue
        meta = e.get("meta") or {}
        rep, rrid = meta.get("replica"), meta.get("replica_rid")
        if rep is None or rrid is None:
            continue
        child = lookup(rep, rrid)
        if child is None:
            continue
        for ce in child.get("events", ()):
            if ce["event"] == "submitted":
                # the replica's admission-queue entry — keep the mark,
                # but as the vocabulary's 'queued' (the router-level
                # 'submitted' opened the request)
                ce = dict(ce, event="queued")
            rec = dict(ce)
            rec["scope"] = child.get("scope")
            merged.append(rec)
    merged.sort(key=lambda r: (r["t"],
                               0 if r["event"] != "terminal" else
                               (2 if (final_t is not None
                                      and r["t"] == final_t
                                      and r["scope"] ==
                                      router_timeline.get("scope"))
                                else 1)))
    out = dict(router_timeline)
    out["events"] = merged
    out["stitched"] = True
    return out


# ---------------------------------------------------------------------------
# Exemplars: worst-k latency samples keep their request id
# ---------------------------------------------------------------------------
class ExemplarStore:
    """Top-k worst observations per metric kind, with request identity.

    The TTFT/ITL histograms aggregate away WHICH request sat in the p99
    bucket; this store keeps the k worst ``(value, scope, rid, t)``
    samples so ``tools/request_trace.py`` (and loadgen's
    summary) can jump from a percentile regression to the concrete
    timelines behind it. O(1) fast-path: a sample below the current
    k-th worst costs one float compare."""

    def __init__(self, k: int = 8):
        self._lock = threading.Lock()
        self._k = k
        self._worst: Dict[str, List[dict]] = {}
        self._floor: Dict[str, float] = {}

    def note(self, kind: str, scope: str, rid: int, value: float,
             t: float):
        if value < self._floor.get(kind, float("-inf")):
            return
        with self._lock:
            rows = self._worst.setdefault(kind, [])
            rows.append({"kind": kind, "scope": scope, "rid": int(rid),
                         "value": float(value), "t": float(t)})
            rows.sort(key=lambda r: -r["value"])
            del rows[self._k:]
            self._floor[kind] = (rows[-1]["value"]
                                 if len(rows) >= self._k
                                 else float("-inf"))

    def worst(self, kind: str, k: Optional[int] = None) -> List[dict]:
        with self._lock:
            rows = list(self._worst.get(kind, ()))
        return rows[:k] if k else rows

    def snapshot(self) -> Dict[str, List[dict]]:
        with self._lock:
            return {k: [dict(r) for r in v]
                    for k, v in self._worst.items()}

    def clear(self):
        with self._lock:
            self._worst.clear()
            self._floor.clear()


#: process-global exemplar store (ttft / itl kinds)
EXEMPLARS = ExemplarStore()


# ---------------------------------------------------------------------------
# SLO burn-rate accounting (multiwindow, SRE-style)
# ---------------------------------------------------------------------------
class SloTracker:
    """Sliding-window error-budget burn rates for one scope.

    ``note(t, good)`` on every terminal outcome; the two gauges export
    ``bad_fraction / (1 - slo_target)`` over a fast and a slow window.
    The deadline knobs in ``ResilienceConfig`` decide what *bad* means
    (any non-FINISHED terminal: DEADLINE_MISSED, SHED, FAILED,
    CANCELLED); ``slo_target`` is the objective those deadlines serve.
    Timestamps come from the producer's clock seam, so FakeClock tests
    drive the windows deterministically."""

    def __init__(self, scope: str, target: float = 0.99,
                 fast_window_s: float = 60.0,
                 slow_window_s: float = 600.0):
        if not 0.0 < target < 1.0:
            raise ValueError("slo_target must be in (0, 1)")
        if not 0.0 < fast_window_s <= slow_window_s:
            raise ValueError(
                "need 0 < slo_fast_window_s <= slo_slow_window_s")
        self.scope = scope
        self.target = target
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        # per-window event deques with INCREMENTAL bad/total counts —
        # a note costs O(pruned), never a window scan (a 600 s window
        # at serving rates holds tens of thousands of outcomes)
        self._win = {
            "fast": [collections.deque(), 0, 0, fast_window_s],
            "slow": [collections.deque(), 0, 0, slow_window_s],
        }
        self._lock = threading.Lock()

    def note(self, t: float, good: bool):
        """Record one terminal outcome and refresh both gauges."""
        t = float(t)
        with self._lock:
            for st in self._win.values():
                dq, _, _, window = st
                dq.append((t, good))
                st[1] += 1
                st[2] += not good
                horizon = t - window
                while dq and dq[0][0] < horizon:
                    _, g = dq.popleft()
                    st[1] -= 1
                    st[2] -= not g
            rates = self._rates_locked()
        M_SLO_FAST_BURN.set(rates["fast"], scope=self.scope)
        M_SLO_SLOW_BURN.set(rates["slow"], scope=self.scope)

    def _rates_locked(self) -> Dict[str, float]:
        budget = 1.0 - self.target
        return {name: (st[2] / st[1] / budget) if st[1] else 0.0
                for name, st in self._win.items()}

    def burn_rates(self, now: Optional[float] = None) -> Dict[str, float]:
        """Current burn rates; ``now`` additionally prunes entries that
        have aged out since the last note AND re-exports the gauges —
        the gauges otherwise only move on terminal outcomes, so an
        idle-after-incident tier would pin the alert level high forever.
        ``health()`` on the engine/router polls this."""
        with self._lock:
            if now is not None:
                for st in self._win.values():
                    dq, _, _, window = st
                    horizon = float(now) - window
                    while dq and dq[0][0] < horizon:
                        _, g = dq.popleft()
                        st[1] -= 1
                        st[2] -= not g
            rates = self._rates_locked()
        if now is not None:
            M_SLO_FAST_BURN.set(rates["fast"], scope=self.scope)
            M_SLO_SLOW_BURN.set(rates["slow"], scope=self.scope)
        return rates


# ---------------------------------------------------------------------------
# Persistence (exit dump + watchdog hang path)
# ---------------------------------------------------------------------------
def record_path(base: Optional[str] = None,
                rank: Optional[int] = None) -> Optional[str]:
    """Per-rank dump path ``<base>.r<rank>`` (every rank suffixed, rank 0
    included)."""
    base = base if base is not None else os.environ.get(RECORD_ENV)
    if not base:
        return None
    r = rank if rank is not None else rank_world()[0]
    return f"{base}.r{r}"


def dump(path: Optional[str] = None, reason: str = "") -> Optional[str]:
    """Persist terminal + live timelines (and exemplars) to ``path``
    (default: the rank-suffixed ``PADDLE_TPU_REQTRACE`` path). Never
    raises — this runs from crash/hang paths."""
    try:
        path = path or record_path()
        if not path:
            return None
        rank, world = rank_world()
        live = RECORDER.live_timelines()
        for tl in live:
            tl["open"] = True
        payload = {"format": "paddle_tpu.reqtrace/1",
                   "rank": rank, "world": world, "pid": os.getpid(),
                   "reason": reason, "unix_time": time.time(),
                   "perf_counter": time.perf_counter(),
                   "exemplars": EXEMPLARS.snapshot(),
                   "timelines": RECORDER.tail() + live}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return path
    except Exception:
        return None


def load_dump(path: str) -> dict:
    """Load one reqtrace dump file (format-checked)."""
    with open(path) as f:
        payload = json.load(f)
    if payload.get("format") != "paddle_tpu.reqtrace/1":
        raise ValueError(f"{path}: not a reqtrace dump "
                         f"(format={payload.get('format')!r})")
    return payload


def _install_exit_dump():
    """Registered unconditionally: ``dump()`` re-reads the env at exit,
    so setting PADDLE_TPU_REQTRACE after import still produces a record
    (and an unset one stays a no-op)."""
    import atexit
    atexit.register(lambda: dump(reason="atexit"))


_install_exit_dump()
