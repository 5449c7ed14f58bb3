"""Multi-replica serving router: the tier's front door (counterpart of
``paddle_tpu/serving/router.py``).

Fronts R :class:`~paddle_tpu_torch.inference.PagedEngine` replicas with
one ``add_request``/``step``/``stream``/``drain_outcomes`` surface (the
same duck type as a single engine, so ``tools/loadgen.py`` drives a
router and a replica identically). Policy, in order:

* **Admission keys on the readiness probes**: only ``READY`` replicas
  receive new traffic; a ``DEGRADED``/``DRAINING``/``WARMING`` replica
  drops out of rotation the moment its lifecycle flips.
* **Load balancing on queue depth**: candidates are ordered by
  ``health()`` backlog (queued + active), so a slow replica sheds load
  to its peers instead of building a deep queue.
* **Backpressure retry**: a replica's bounded admission queue raising
  :class:`Overloaded` bounces the request to the next candidate; the
  submitter never sees a replica-level rejection.
* **Shed at the router, never inside a replica**: when every candidate
  is saturated (or none is READY), the request becomes a router-level
  ``SHED`` outcome without ever touching a replica queue. Replicas run
  with shedding disabled in router deployments.
* **Re-routing**: a request stranded by a replica failure (tick-crash
  ``FAILED``) or a drain-before-admission ``CANCELLED`` is resubmitted
  to another replica with its already-generated tokens as prompt
  prefix: paid-for prefill/decode work is carried, not discarded.

Replicas may share one model (each owns its KV pool); one host thread
ticks them in turn, so R replicas on one card share its time.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..core.place import DeviceLike, resolve_device
from ..inference.resilience import (Overloaded, RequestOutcome,
                                    RequestStatus, TERMINAL_STATUSES)
from ..observability import metrics as _metrics
from ..observability import reqtrace as _reqtrace
from .stream import TokenStream

__all__ = ["RouterConfig", "Router"]

#: default router-name ordinals (stable within one process, like the
#: replica counter in inference/resilience.py)
_ROUTER_COUNTER = itertools.count(0)


M_ROUTER_ROUTED = _metrics.counter(
    "paddle_tpu_serving_router_routed_total",
    "Requests the router admitted into a replica, by replica name.",
    labelnames=("replica",))
M_ROUTER_RETRIES = _metrics.counter(
    "paddle_tpu_serving_router_retries_total",
    "Submit attempts bounced by replica Overloaded backpressure and "
    "retried on the next candidate.")
M_ROUTER_SHED = _metrics.counter(
    "paddle_tpu_serving_router_shed_total",
    "Requests shed at the router because no READY replica could admit "
    "them (replicas never saw these).")
M_ROUTER_REROUTED = _metrics.counter(
    "paddle_tpu_serving_router_rerouted_total",
    "Requests re-routed to another replica after a replica failure or "
    "drain stranded them mid-flight.")


@dataclass
class RouterConfig:
    """``max_reroutes``: per-request bound on failure re-routes before
    the stranding outcome is surfaced to the client (defaults to the
    replica count). ``reroute_failed`` / ``reroute_drained``: which
    stranding outcomes are retried. The ``slo_*`` knobs feed the
    tier-level ``paddle_tpu_serving_slo_{fast,slow}_burn_rate`` gauges
    (scope = the router's name) — the client-visible SLO lives HERE,
    where shedding happens, not per replica."""

    max_reroutes: Optional[int] = None
    reroute_failed: bool = True
    reroute_drained: bool = True
    slo_target: float = 0.99
    slo_fast_window_s: float = 60.0
    slo_slow_window_s: float = 600.0


@dataclass
class _RoutedRequest:
    """Router-side bookkeeping for one client request across replicas."""

    rid: int
    prompt: List[int]
    max_new_tokens: int
    temperature: float
    top_p: float
    ttft_deadline_s: Optional[float]
    deadline_s: Optional[float]
    submit_t: float
    tokens: List[int] = field(default_factory=list)
    token_times: List[float] = field(default_factory=list)
    first_token_t: Optional[float] = None
    replica_idx: Optional[int] = None
    replica_rid: Optional[int] = None
    reroutes: int = 0
    stream_buf: Optional[List[int]] = None    # router-level delta buffer
    _rep_buf: Optional[List[int]] = None      # current replica's buffer
    _rep_read: int = 0


class Router:
    """Route client requests across R paged-engine replicas.

    The router is single-threaded like the engines it fronts: ``step()``
    ticks every replica with work, then settles outcomes (collect,
    re-route, record). It keeps only live bookkeeping plus undrained
    outcomes — the same retention contract as one replica.

    ``device`` (default the card; ``device="cpu"`` asks for the CPU)
    names where the replicas run: each must be on a device of its type.
    """

    def __init__(self, replicas, *, config: Optional[RouterConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 name: Optional[str] = None, device: DeviceLike = None):
        if not replicas:
            raise ValueError("Router needs at least one replica")
        self.device = resolve_device(device)
        for rep in replicas:
            if rep.device.type != self.device.type:
                raise ValueError(f"a replica runs on {rep.device}, the "
                                 f"router on {self.device}")
        self.replicas = list(replicas)
        self.config = config or RouterConfig()
        self._clock = clock
        #: stable reqtrace scope / SLO-gauge label for this tier
        self.name = name if name is not None else \
            f"router{next(_ROUTER_COUNTER)}"
        self._slo = _reqtrace.SloTracker(
            self.name, target=self.config.slo_target,
            fast_window_s=self.config.slo_fast_window_s,
            slow_window_s=self.config.slo_slow_window_s)
        self._rid = 0
        self._live: Dict[Tuple[int, int], _RoutedRequest] = {}
        self._by_rid: Dict[int, _RoutedRequest] = {}
        #: terminal outcome per router-level request id
        self.outcomes: Dict[int, RequestOutcome] = {}
        self.per_replica = [
            {"routed": 0, "finished": 0, "good_tokens": 0, "rerouted_away": 0}
            for _ in self.replicas]
        self.shed_at_router = 0
        self._draining = False

    # ------------------------------------------------------------ policy
    def _candidates(self) -> List[int]:
        """READY replicas, least-loaded first (queue depth + active)."""
        scored = []
        for i, rep in enumerate(self.replicas):
            if not rep.lifecycle.ready():
                continue
            h = rep.health()
            scored.append((h["queue_depth"] + h["active"], i))
        scored.sort()
        return [i for _, i in scored]

    def _max_reroutes(self) -> int:
        mr = self.config.max_reroutes
        return len(self.replicas) if mr is None else mr

    # ------------------------------------------------- request tracing
    @property
    def reqtrace_scope(self) -> str:
        """Timeline scope tier-level events record under; replica legs
        are joined through the ``routed`` events (reqtrace.stitch)."""
        return self.name

    def _rt_event(self, rid: int, event: str,
                  t: Optional[float] = None, **meta):
        _reqtrace.emit(self.name, self._clock, rid, event, t, **meta)

    # --------------------------------------------------------------- API
    def warmup(self) -> "Router":
        for rep in self.replicas:
            rep.warmup()
        return self

    def add_request(self, prompt_ids, max_new_tokens: int = 32,
                    temperature: float = 0.0, top_p: float = 1.0,
                    ttft_deadline_s: Optional[float] = None,
                    deadline_s: Optional[float] = None) -> int:
        """Admit one request into the tier; returns the router-level
        request id. Never raises for overload — a request no replica can
        take becomes a router-level ``SHED`` outcome (the router is
        where the tier sheds; clients poll/stream by rid either way)."""
        self._rid += 1
        rr = _RoutedRequest(
            rid=self._rid, prompt=[int(t) for t in prompt_ids],
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_p=top_p, ttft_deadline_s=ttft_deadline_s,
            deadline_s=deadline_s, submit_t=self._clock())
        self._by_rid[rr.rid] = rr
        self._rt_event(rr.rid, "submitted", t=rr.submit_t,
                       prompt_tokens=len(rr.prompt),
                       max_new_tokens=max_new_tokens,
                       ttft_deadline_s=ttft_deadline_s,
                       deadline_s=deadline_s)
        if not self._try_submit(rr):
            # the shed CAUSE gets a timestamped event of its own (not
            # just the terminal outcome), so a shed storm's timelines
            # say which rotation state refused the tier's traffic
            ready = sum(1 for rep in self.replicas
                        if rep.lifecycle.ready())
            self._rt_event(rr.rid, "shed",
                           ready_replicas=ready,
                           replicas=len(self.replicas))
            self.shed_at_router += 1
            M_ROUTER_SHED.inc()
            self._finish(rr, RequestStatus.SHED,
                         detail="router: no READY replica could admit "
                                "(all saturated or out of rotation)")
        return rr.rid

    def _try_submit(self, rr: _RoutedRequest, exclude=()) -> bool:
        """Submit ``rr`` (or its continuation) to the best candidate;
        False when every candidate refused."""
        remaining = rr.max_new_tokens - len(rr.tokens)
        prompt = rr.prompt + rr.tokens
        bounced = 0
        for i in self._candidates():
            if i in exclude:
                continue
            rep = self.replicas[i]
            try:
                rrid = rep.add_request(
                    prompt, max_new_tokens=remaining,
                    temperature=rr.temperature, top_p=rr.top_p,
                    ttft_deadline_s=rr.ttft_deadline_s,
                    deadline_s=rr.deadline_s)
            except Overloaded:
                M_ROUTER_RETRIES.inc()
                bounced += 1
                continue
            # submit-time terminal (never-fitting geometry): surface it
            # from this replica rather than looping the tier
            rr.replica_idx, rr.replica_rid = i, rrid
            self._live[(i, rrid)] = rr
            self.per_replica[i]["routed"] += 1
            self._rt_event(rr.rid, "routed",
                           replica=rep.lifecycle.name,
                           replica_rid=rrid,
                           tokens_carried=len(rr.tokens),
                           overloaded_bounces=bounced)
            M_ROUTER_ROUTED.inc(replica=rep.lifecycle.name)
            if rr.stream_buf is not None:
                rr._rep_buf = rep.open_stream(rrid)
                rr._rep_read = 0
            return True
        return False

    def has_work(self) -> bool:
        if any(rep.has_work() for rep in self.replicas):
            return True
        # a replica drained/crashed outside step() may hold terminal
        # outcomes of ours that still need settling (and possibly
        # re-routing) — that is work for the next tick
        return any((i, rrid) in self._live
                   for i, rep in enumerate(self.replicas)
                   for rrid in rep.outcomes)

    def step(self) -> Dict[int, List[int]]:
        """One tier tick: tick every replica with work, then settle
        outcomes. Returns {router_rid: full_token_list} for requests
        that FINISHED this tick."""
        for rep in self.replicas:
            if rep.has_work() and rep.lifecycle.live():
                rep.step()
        self._pump_streams()
        return self._settle()

    def run_to_completion(self, max_ticks: int = 10_000) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        ticks = 0
        while self.has_work():
            out.update(self.step())
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError("router did not converge")
        return out

    # ---------------------------------------------------------- settling
    def _pump_streams(self):
        """Move per-tick token deltas replica buffer -> router buffer
        for requests with an open stream."""
        for rr in self._live.values():
            if rr.stream_buf is None or rr._rep_buf is None:
                continue
            new = rr._rep_buf[rr._rep_read:]
            if new:
                rr._rep_read += len(new)
                rr.stream_buf.extend(new)

    def _settle(self) -> Dict[int, List[int]]:
        finished: Dict[int, List[int]] = {}
        for i, rep in enumerate(self.replicas):
            for rrid, oc in rep.drain_outcomes().items():
                rr = self._live.pop((i, rrid), None)
                if rr is None:
                    continue       # not ours (e.g. direct submissions)
                self._absorb(rr, oc, i, finished)
        return finished

    def _absorb(self, rr: _RoutedRequest, oc: RequestOutcome,
                replica_idx: int, finished: Dict[int, List[int]]):
        rr.tokens.extend(oc.tokens)
        rr.token_times.extend(oc.token_times)
        if rr.first_token_t is None:
            rr.first_token_t = oc.first_token_t
        rr.replica_idx = rr.replica_rid = None
        rr._rep_buf, rr._rep_read = None, 0
        if oc.status == RequestStatus.FINISHED:
            self.per_replica[replica_idx]["finished"] += 1
            self.per_replica[replica_idx]["good_tokens"] += len(oc.tokens)
            self._finish(rr, RequestStatus.FINISHED)
            finished[rr.rid] = list(rr.tokens)
            return
        if (self._should_reroute(oc)
                and rr.reroutes < self._max_reroutes()
                and len(rr.tokens) < rr.max_new_tokens):
            rr.reroutes += 1
            self.per_replica[replica_idx]["rerouted_away"] += 1
            self._rt_event(
                rr.rid, "rerouted",
                from_replica=self.replicas[replica_idx].lifecycle.name,
                stranding_outcome=oc.status, stranding_detail=oc.detail,
                tokens_carried=len(rr.tokens), reroutes=rr.reroutes)
            M_ROUTER_REROUTED.inc()
            if self._try_submit(rr, exclude=(replica_idx,)):
                return
            # nobody else could take it — surface the stranding outcome
            self._finish(rr, oc.status,
                         detail=f"re-route failed: {oc.detail}")
            return
        self._finish(rr, oc.status, detail=oc.detail)

    def _should_reroute(self, oc: RequestOutcome) -> bool:
        cfg = self.config
        if self._draining:
            # a tier-level drain cancels everywhere at once — counting
            # (and failing) a re-route per stranded request would be
            # phantom telemetry; the CANCELLED outcome passes through
            return False
        if oc.status == RequestStatus.FAILED:
            return cfg.reroute_failed and "blocks" not in oc.detail
        if oc.status == RequestStatus.CANCELLED:
            return cfg.reroute_drained and "drain" in oc.detail
        return False

    def _finish(self, rr: _RoutedRequest, status: str, detail: str = ""):
        finish_t = self._clock()
        self._rt_event(rr.rid, "terminal", t=finish_t, outcome=status,
                       detail=detail, tokens=len(rr.tokens))
        self._slo.note(finish_t, good=(status == RequestStatus.FINISHED))
        self.outcomes[rr.rid] = RequestOutcome(
            rid=rr.rid, status=status, detail=detail,
            tokens=list(rr.tokens), submit_t=rr.submit_t,
            first_token_t=rr.first_token_t, finish_t=finish_t,
            token_times=list(rr.token_times))
        self._by_rid.pop(rr.rid, None)

    # --------------------------------------------------------- inspection
    def request_status(self, rid: int) -> Optional[str]:
        oc = self.outcomes.get(rid)
        if oc is not None:
            return oc.status
        rr = self._by_rid.get(rid)
        if rr is None:
            return None
        if rr.replica_idx is not None:
            st = self.replicas[rr.replica_idx].request_status(rr.replica_rid)
            if st is not None:
                return st
        return RequestStatus.QUEUED

    def drain_outcomes(self) -> Dict[int, RequestOutcome]:
        out, self.outcomes = self.outcomes, {}
        return out

    def stream(self, rid: int) -> TokenStream:
        """Incremental token stream for a live (or just-submitted)
        request; survives re-routing — the stream keeps yielding across
        a replica hand-off."""
        rr = self._by_rid.get(rid)
        buf: List[int] = []
        if rr is not None:
            if rr.stream_buf is None:
                # late attach replays the whole completion so far:
                # tokens carried from previous replicas (re-routes fold
                # them into rr.tokens), then the current replica's
                rr.stream_buf = list(rr.tokens)
                if rr.replica_idx is not None:
                    rep = self.replicas[rr.replica_idx]
                    rr._rep_buf = rep.open_stream(rr.replica_rid)
                    rr._rep_read = 0
                    rr.stream_buf.extend(rr._rep_buf)
                    rr._rep_read = len(rr._rep_buf)
            buf = rr.stream_buf
        else:
            oc = self.outcomes.get(rid)
            if oc is not None:
                buf = list(oc.tokens)
        return TokenStream(
            rid, buf, self.step, lambda: self.request_status(rid),
            lambda s: s in TERMINAL_STATUSES,
            trace_hook=lambda ev, **meta: self._rt_event(rid, ev, **meta))

    def drain(self) -> Dict[int, List[int]]:
        """Drain every replica and settle all remaining outcomes."""
        self._draining = True
        for rep in self.replicas:
            if rep.lifecycle.live():
                rep.drain()
        finished: Dict[int, List[int]] = {}
        self._pump_streams()
        finished.update(self._settle())
        # anything still live points at a stopped replica: terminal
        for key, rr in list(self._live.items()):
            self._live.pop(key)
            self._finish(rr, RequestStatus.CANCELLED,
                         detail="router drained")
        return finished

    def health(self) -> dict:
        """Tier-level health: aggregate + per-replica probe payloads."""
        reps = [rep.health() for rep in self.replicas]
        return {
            "replicas": len(self.replicas),
            "ready": sum(1 for rep in self.replicas
                         if rep.lifecycle.ready()),
            "live": sum(1 for rep in self.replicas
                        if rep.lifecycle.live()),
            "queue_depth": sum(h["queue_depth"] for h in reps),
            "active": sum(h["active"] for h in reps),
            "shed_at_router": self.shed_at_router,
            # probe-path burn-rate decay poll (see PagedEngine.health)
            "slo_burn_rate": self._slo.burn_rates(self._clock()),
            "per_replica": reps,
        }

    def stats(self) -> dict:
        """Routing breakdown for load reports (``run_load``'s
        ``router`` field)."""
        return {
            "shed_at_router": self.shed_at_router,
            "per_replica": [
                {"replica": rep.lifecycle.name, **counts,
                 "state": rep.lifecycle.state}
                for rep, counts in zip(self.replicas, self.per_replica)],
        }
