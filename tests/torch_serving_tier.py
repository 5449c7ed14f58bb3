"""Shared harness of the serving-tier parity tests (``test_torch_resilience``,
``test_torch_router``, ``test_torch_loadgen``, ``test_torch_reqtrace``).

A scenario is a function of one :class:`Pkg`, the same code for both
packages: it builds engines (and routers) through the ``Pkg``, drives
them, asserts what the JAX package's own tests assert, and returns what
it read. ``run_both`` runs it on the JAX package and on the port (on CPU
tensors, the same tiny GQA LLaMA weights through ``load_jax_state``),
each from a reset registry, recorder and exemplar store, with metrics
and request tracing on, every engine and router on its own
:class:`FakeClock`; it returns both records: what the scenario returned,
and for every engine and router the outcomes, ``health()``, the
lifecycle history, the tick counts, the serving metrics and the request
timelines, with replica and router names replaced by their order of
creation. The two records must be equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np

import paddle_tpu as jpkg
import paddle_tpu.distributed.watchdog as jwatchdog
import paddle_tpu.fault.inject as jinject
import paddle_tpu.inference as jinference
import paddle_tpu.inference.resilience as jresilience
import paddle_tpu.observability as jobs
import paddle_tpu.serving as jserving
import paddle_tpu_torch as tpkg
import paddle_tpu_torch.distributed.watchdog as twatchdog
import paddle_tpu_torch.fault.inject as tinject
import paddle_tpu_torch.inference as tinference
import paddle_tpu_torch.inference.resilience as tresilience
import paddle_tpu_torch.observability as tobs
import paddle_tpu_torch.serving as tserving
from test_torch_llama_generate import llama_pair

VOCAB = 97
#: every read of a FakeClock advances it by this much (an exact binary
#: fraction, so timestamps add up exactly in both packages)
TICK = 2.0 ** -10


class FakeClock:
    """Deterministic clock: each read returns ``t`` and advances it by
    ``step``, so every timestamp depends on the order of the clock reads
    (``step=0`` holds it still, for drills with a second thread)."""

    def __init__(self, t: float = 0.0, step: float = TICK):
        self.t = t
        self.step = step

    def __call__(self) -> float:
        t = self.t
        self.t += self.step
        return t

    def install(self, eng):
        eng._clock = self
        eng.lifecycle._clock = self
        return self


@dataclasses.dataclass
class Pkg:
    """One package's serving tier, as a scenario sees it."""

    name: str
    model: object
    PagedEngine: type
    ResilienceConfig: type
    Router: type
    RouterConfig: type
    SchedulerConfig: type
    RS: type                 # RequestStatus
    ReplicaState: type
    Overloaded: type
    TERMINAL: frozenset
    inject: object
    Watchdog: type
    REGISTRY: object
    reqtrace: object
    trace: object
    set_flags: object
    resilience: object
    device_kw: dict
    engines: list = dataclasses.field(default_factory=list)
    routers: list = dataclasses.field(default_factory=list)

    def make_engine(self, *, max_batch=2, block_size=4, num_blocks=32,
                    max_blocks_per_seq=16, clock=None, engine_kw=None,
                    **res_kw):
        """The JAX tests' ``make_engine``; the engine goes on ``clock``
        (a new FakeClock by default)."""
        res = self.ResilienceConfig(**res_kw) if res_kw else None
        eng = self.PagedEngine(self.model, max_batch=max_batch,
                               block_size=block_size, num_blocks=num_blocks,
                               max_blocks_per_seq=max_blocks_per_seq,
                               resilience=res, **(engine_kw or {}),
                               **self.device_kw)
        (clock or FakeClock()).install(eng)
        self.engines.append(eng)
        return eng

    def make_router(self, replicas, clock=None, **cfg):
        router = self.Router(replicas, config=self.RouterConfig(**cfg),
                             clock=clock or FakeClock(), **self.device_kw)
        self.routers.append(router)
        return router


def packages(kind: str = "gqa"):
    jmodel, tmodel = llama_pair(kind)
    jax_side = Pkg(
        "jax", jmodel, jinference.PagedEngine, jinference.ResilienceConfig,
        jserving.Router, jserving.RouterConfig, jserving.SchedulerConfig,
        jinference.RequestStatus, jinference.ReplicaState,
        jinference.Overloaded, jresilience.TERMINAL_STATUSES, jinject,
        jwatchdog.Watchdog, jobs.REGISTRY, jobs.reqtrace, jobs.trace,
        jpkg.set_flags, jresilience, {})
    torch_side = Pkg(
        "torch", tmodel, tinference.PagedEngine, tinference.ResilienceConfig,
        tserving.Router, tserving.RouterConfig, tserving.SchedulerConfig,
        tinference.RequestStatus, tinference.ReplicaState,
        tinference.Overloaded, tresilience.TERMINAL_STATUSES, tinject,
        twatchdog.Watchdog, tobs.REGISTRY, tobs.reqtrace, tobs.trace,
        tpkg.set_flags, tresilience, {"device": "cpu"})
    return jax_side, torch_side


def prompt(seed, n=5):
    rng = np.random.RandomState(seed)
    return [int(t) for t in rng.randint(1, VOCAB, size=n)]


def assert_quiesced(pkg, eng, rids):
    """The drill invariant: every submitted request terminal, no KV block
    leaked, no slot occupied, queue empty."""
    for rid in rids:
        oc = eng.outcomes.get(rid)
        assert oc is not None, f"request {rid} has no terminal outcome"
        assert oc.status in pkg.TERMINAL, (rid, oc.status)
    assert not eng.queue
    assert all(s is None for s in eng.slots)
    assert eng.bm.available == eng._total_usable, "leaked KV blocks"


# ------------------------------------------------------------ the record
#: serving metrics whose values come from the host's clock: only their
#: sample counts are compared
_HOST_TIMED = {"paddle_tpu_serving_tick_seconds"}
_SKIPPED = {"paddle_tpu_serving_tick_phase_share"}


def outcome_record(oc):
    return dict(status=oc.status, detail=oc.detail, tokens=list(oc.tokens),
                submit_t=oc.submit_t, first_token_t=oc.first_token_t,
                finish_t=oc.finish_t, token_times=list(oc.token_times))


class Names:
    """Replica and router names -> their order of creation."""

    def __init__(self, pkg):
        self.map = {e.lifecycle.name: f"replica#{i}"
                    for i, e in enumerate(pkg.engines)}
        self.map.update({r.name: f"router#{i}"
                         for i, r in enumerate(pkg.routers)})

    def __call__(self, value):
        if isinstance(value, str):
            scope, sep, rest = value.partition("/")    # "replica3/rid=7"
            return self.map.get(scope, scope) + sep + rest
        if isinstance(value, dict):
            return {k: self(v) for k, v in value.items()}
        if isinstance(value, (list, tuple)):
            return type(value)(self(v) for v in value)
        return value


def metrics_record(pkg, names):
    """The port's serving and reqtrace instruments, read from ``pkg``'s
    registry."""
    out = {}
    for m in tobs.REGISTRY.collect():
        if not m.name.startswith(("paddle_tpu_serving", "paddle_tpu_reqtrace")):
            continue
        if m.name in _SKIPPED:
            continue
        theirs = pkg.REGISTRY.get(m.name)
        snap = {} if theirs is None else {
            tuple(names(list(k))): v for k, v in theirs._series()}
        if m.name in _HOST_TIMED:
            snap = {k: v["count"] for k, v in snap.items()}
        if snap:
            out[m.name] = snap
    return out


def timelines_record(pkg, names):
    rec = pkg.reqtrace.RECORDER
    tls = rec.tail() + rec.live_timelines()
    return sorted((names(tl["scope"]), tl["rid"], tl.get("dropped", 0),
                   names(tl["events"])) for tl in tls)


def record(pkg, returned):
    names = Names(pkg)
    engines = []
    for eng in pkg.engines:
        health = eng.health()
        health.pop("phase_share")          # host seconds
        engines.append(dict(
            outcomes={rid: outcome_record(oc)
                      for rid, oc in sorted(eng.outcomes.items())},
            health=names(health), ticks=eng._ticks,
            tick_failures=eng.tick_failures,
            history=names([list(h) for h in eng.lifecycle.history]),
            free=eng.bm.available))
    routers = [dict(outcomes={rid: outcome_record(oc)
                              for rid, oc in sorted(r.outcomes.items())},
                    health=names(_router_health(r)),
                    stats=names(r.stats()))
               for r in pkg.routers]
    return dict(returned=names(returned), engines=engines, routers=routers,
                metrics=metrics_record(pkg, names),
                timelines=timelines_record(pkg, names),
                exemplars=names(pkg.reqtrace.EXEMPLARS.snapshot()))


def _router_health(router):
    h = router.health()
    for rep in h["per_replica"]:
        rep.pop("phase_share")
    return h


def reset(pkg):
    pkg.engines.clear()
    pkg.routers.clear()
    pkg.inject.disarm_all()
    pkg.REGISTRY.reset()
    pkg.reqtrace.RECORDER.clear()
    pkg.reqtrace.EXEMPLARS.clear()


def run_both(scenario, kind: str = "gqa"):
    """(JAX record, port record) of ``scenario``."""
    records = []
    for pkg in packages(kind):
        reset(pkg)
        pkg.set_flags({"FLAGS_enable_metrics": True, "FLAGS_reqtrace": True})
        try:
            returned = scenario(pkg)
            records.append(record(pkg, returned))
        finally:
            pkg.set_flags({"FLAGS_enable_metrics": False})
            pkg.inject.disarm_all()
            reset(pkg)
    return records
