"""The port's request flight recorder against the JAX package's.

The same event streams (seeded with numpy: several scopes and requests,
stream-delivery marks after terminal and repeated, events after
terminal, more events than a timeline's cap, more terminal timelines
than the ring retains) go into a ``RequestTraceRecorder`` of each
package with the same caps; the retained and live timelines, the
eviction counts and the event budget must be equal, and so must
``segments``, ``segment_intervals``, ``validate`` and ``stitch`` of
every timeline, the ``ExemplarStore`` and the ``SloTracker`` burn rates
(the metrics they export included), a ``dump``/``load_dump`` round
trip, and the request-trace tool's waterfall and chrome trace. With
``FLAGS_reqtrace`` off an engine run reads the clock exactly as often
as the JAX engine's does, and fewer times than with it on.
"""
import json

import numpy as np
import pytest

import paddle_tpu as jpkg
import paddle_tpu_torch as tpkg
from paddle_tpu.observability import REGISTRY as JREG
from paddle_tpu.observability import reqtrace as jrt
from paddle_tpu_torch.observability import REGISTRY as TREG
from paddle_tpu_torch.observability import reqtrace as trt
from paddle_tpu_torch.tools import request_trace as t_tool
from tools import request_trace as j_tool
from torch_serving_tier import FakeClock, packages, prompt

LIFECYCLE = ("submitted", "queued", "admitted", "prefill_chunk",
             "prefill_deferred", "first_token", "decode_tick",
             "spec_verify", "preempted", "rerouted", "shed")
OUTCOMES = ("FINISHED", "FAILED", "SHED", "CANCELLED", "DEADLINE_MISSED")


def event_stream(seed, n=400, scopes=("replica0", "replica1", "router0"),
                 rids=12):
    """(scope, rid, event, t, meta) tuples with non-decreasing times a
    request, terminals, marks after terminal and events past it."""
    rng = np.random.RandomState(seed)
    t = {}
    out = []
    for _ in range(n):
        scope = scopes[rng.randint(len(scopes))]
        rid = int(rng.randint(1, rids + 1))
        key = (scope, rid)
        if key not in t:
            t[key] = float(rng.randint(0, 64)) / 8
            out.append((scope, rid, "submitted", t[key],
                        {"prompt_tokens": int(rng.randint(1, 9))}))
            continue
        t[key] += float(rng.randint(0, 16)) / 16
        r = rng.rand()
        if r < 0.08:
            meta = {"outcome": OUTCOMES[rng.randint(len(OUTCOMES))],
                    "detail": "", "tokens": int(rng.randint(0, 9))}
            out.append((scope, rid, "terminal", t[key], meta))
        elif r < 0.16:
            ev = ("first_delivery", "stream_closed")[rng.randint(2)]
            out.append((scope, rid, ev, t[key], None))
        else:
            ev = LIFECYCLE[1 + rng.randint(len(LIFECYCLE) - 1)]
            out.append((scope, rid, ev, t[key], {"tick": int(t[key] * 8)}))
    return out


def fill(mod, stream, **caps):
    rec = mod.RequestTraceRecorder(**caps)
    for scope, rid, ev, t, meta in stream:
        rec.event(scope, rid, ev, t, meta)
    return rec


def recorder_state(rec):
    return dict(tail=rec.tail(), live=rec.live_timelines(),
                evicted=rec.evicted, done_events=rec._done_events)


CAPS = {"default": {}, "tight": dict(retain=5, max_events=7,
                                     max_retained_events=30)}


@pytest.mark.parametrize("caps", sorted(CAPS))
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_recorder_matches_jax(seed, caps):
    stream = event_stream(seed)
    JREG.reset()
    TREG.reset()
    jpkg.set_flags({"FLAGS_enable_metrics": True})
    tpkg.set_flags({"FLAGS_enable_metrics": True})
    try:
        jrec = fill(jrt, stream, **CAPS[caps])
        trec = fill(trt, stream, **CAPS[caps])
    finally:
        jpkg.set_flags({"FLAGS_enable_metrics": False})
        tpkg.set_flags({"FLAGS_enable_metrics": False})
    assert recorder_state(trec) == recorder_state(jrec)
    assert recorder_state(trec)["tail"]          # not vacuous
    for name in ("paddle_tpu_reqtrace_evicted_total",
                 "paddle_tpu_reqtrace_dropped_events_total"):
        assert TREG.get(name).total() == JREG.get(name).total()
    for tl in trec.tail() + trec.live_timelines():
        assert trec.timeline(tl["scope"], tl["rid"]) == \
            jrec.timeline(tl["scope"], tl["rid"])


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_segments_validate_and_intervals_match_jax(seed):
    rec = fill(trt, event_stream(seed))
    tls = rec.tail() + rec.live_timelines()
    assert tls
    for tl in tls:
        assert trt.segments(tl) == jrt.segments(tl)
        assert trt.segment_intervals(tl) == jrt.segment_intervals(tl)
        assert trt.validate(tl) == jrt.validate(tl)
    # the synthetic streams hold complete and broken timelines alike
    verdicts = {not trt.validate(tl) for tl in tls}
    assert verdicts == {True, False}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stitch_matches_jax(seed):
    """A router timeline whose ``routed`` events name replica legs in the
    same stream; legs that were evicted or never opened are skipped."""
    rng = np.random.RandomState(seed)
    rec = trt.RequestTraceRecorder()
    t = 0.0
    routers = []
    for rid in range(1, 7):
        t0 = t
        events = [("submitted", t0, None)]
        for leg in range(int(rng.randint(1, 4))):
            t += float(rng.randint(1, 8)) / 8
            rep = f"replica{int(rng.randint(3))}"
            rrid = rid * 10 + leg
            events.append(("routed", t, {"replica": rep, "replica_rid": rrid}))
            rec.event(rep, rrid, "submitted", t)
            t += 0.25
            rec.event(rep, rrid, "admitted", t)
            t += 0.5
            last = leg == 0 or rng.rand() < 0.5
            rec.event(rep, rrid, "first_token", t)
            rec.event(rep, rrid, "terminal", t + 0.125,
                      {"outcome": "FINISHED" if last else "FAILED"})
            t += 0.25
            if not last:
                events.append(("rerouted", t, {"from_replica": rep}))
        events.append(("terminal", t, {"outcome": "FINISHED"}))
        routers.append({"scope": "router0", "rid": rid,
                        "events": [{"event": e, "t": tt,
                                    **({"meta": m} if m else {})}
                                   for e, tt, m in events]})
    for tl in routers:
        got = trt.stitch(tl, lookup=rec.timeline)
        assert got == jrt.stitch(tl, lookup=rec.timeline)
        assert trt.segments(got) == jrt.segments(got)
        assert trt.validate(got) == jrt.validate(got)


@pytest.mark.parametrize("seed", [0, 1])
def test_exemplar_store_matches_jax(seed):
    rng = np.random.RandomState(seed)
    stores = [jrt.ExemplarStore(k=5), trt.ExemplarStore(k=5)]
    for i in range(200):
        kind = ("ttft", "itl")[rng.randint(2)]
        value = float(rng.randint(0, 50)) / 32   # ties included
        for st in stores:
            st.note(kind, f"replica{i % 3}", i, value, float(i))
    assert stores[1].snapshot() == stores[0].snapshot()
    for kind in ("ttft", "itl"):
        assert stores[1].worst(kind, 3) == stores[0].worst(kind, 3)


@pytest.mark.parametrize("target,fast,slow", [(0.99, 10.0, 100.0),
                                              (0.9, 5.0, 5.0)])
def test_slo_tracker_and_gauges_match_jax(target, fast, slow):
    rng = np.random.RandomState(int(fast))
    JREG.reset()
    TREG.reset()
    jpkg.set_flags({"FLAGS_enable_metrics": True})
    tpkg.set_flags({"FLAGS_enable_metrics": True})
    try:
        trackers = [m.SloTracker("scope", target=target, fast_window_s=fast,
                                 slow_window_s=slow) for m in (jrt, trt)]
        t = 0.0
        rates = [[], []]
        for _ in range(120):
            t += float(rng.randint(0, 8)) / 4
            good = bool(rng.rand() < 0.8)
            poll = bool(rng.rand() < 0.1)
            for i, tr in enumerate(trackers):
                tr.note(t, good)
                rates[i].append(tr.burn_rates())
                if poll:
                    rates[i].append(tr.burn_rates(now=t + 30.0))
            gauges = [(reg.get("paddle_tpu_serving_slo_fast_burn_rate")
                       .value(scope="scope"),
                       reg.get("paddle_tpu_serving_slo_slow_burn_rate")
                       .value(scope="scope")) for reg in (JREG, TREG)]
            assert gauges[1] == gauges[0]
        assert rates[1] == rates[0]
        assert any(r["fast"] > 0 for r in rates[1])
    finally:
        jpkg.set_flags({"FLAGS_enable_metrics": False})
        tpkg.set_flags({"FLAGS_enable_metrics": False})
    for kw in (dict(target=1.5), dict(fast_window_s=100.0,
                                      slow_window_s=10.0)):
        with pytest.raises(ValueError) as want:
            jrt.SloTracker("s", **kw)
        with pytest.raises(ValueError) as got:
            trt.SloTracker("s", **kw)
        assert str(got.value) == str(want.value)


def test_dump_round_trip_matches_jax(tmp_path, monkeypatch):
    """The process recorder and exemplars of each package, dumped to the
    rank-suffixed ``PADDLE_TPU_REQTRACE`` path and loaded back."""
    stream = event_stream(7, n=120)
    payloads = []
    for mod, name in ((jrt, "jax"), (trt, "torch")):
        mod.RECORDER.clear()
        mod.EXEMPLARS.clear()
        try:
            for scope, rid, ev, t, meta in stream:
                mod.RECORDER.event(scope, rid, ev, t, meta)
            mod.EXEMPLARS.note("ttft", "replica0", 3, 0.5, 1.0)
            monkeypatch.setenv(mod.RECORD_ENV, str(tmp_path / name))
            path = mod.dump(reason="test")
            assert path == str(tmp_path / f"{name}.r0")
            payload = mod.load_dump(path)
        finally:
            mod.RECORDER.clear()
            mod.EXEMPLARS.clear()
        for key in ("pid", "unix_time", "perf_counter"):
            payload.pop(key)
        payloads.append(payload)
    assert payloads[1] == payloads[0]
    assert payloads[1]["timelines"]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"format": "other"}))
    with pytest.raises(ValueError, match="not a reqtrace dump"):
        trt.load_dump(str(bad))


def test_request_trace_tool_matches_jax():
    """The waterfall text and the chrome trace (request lanes merged
    with serving spans) of the same timelines."""
    rec = fill(trt, event_stream(3))
    tls = rec.tail() + rec.live_timelines()
    spans = [("serving.tick", "serving", 0.5, 0.75, 0, {"tick": 1}),
             ("serving.decode", "device", 0.5, 0.625, 0, {"phase": "decode"}),
             ("other", "framework", 0.0, 1.0, 1, None)]
    assert t_tool.serving_spans(spans) == j_tool.serving_spans(spans)
    assert (t_tool.chrome_trace(tls, spans=t_tool.serving_spans(spans))
            == j_tool.chrome_trace(tls, spans=j_tool.serving_spans(spans)))
    for tl in tls[:6]:
        assert t_tool.waterfall(tl) == j_tool.waterfall(tl)
    payload = {"timelines": tls, "exemplars": {"ttft": [
        {"kind": "ttft", "scope": tls[0]["scope"], "rid": tls[0]["rid"],
         "value": 1.0, "t": 0.0}]}}
    jsrc, tsrc = j_tool.TimelineSource(payload), t_tool.TimelineSource(payload)
    assert tsrc.worst(3) == jsrc.worst(3)
    assert tsrc.resolve(tls[1]["scope"], tls[1]["rid"]) == \
        jsrc.resolve(tls[1]["scope"], tls[1]["rid"])


class CountingClock(FakeClock):
    def __init__(self):
        super().__init__()
        self.reads = 0

    def __call__(self):
        self.reads += 1
        return super().__call__()


def test_disabled_tracing_reads_no_clock_in_either_engine():
    """With FLAGS_reqtrace off the port's engine reads its clock as often
    as the JAX engine does, records nothing, and reads it fewer times
    than with the flag on; the module's own clock is never read."""
    reads = {}
    for pkg in packages():
        for on in (False, True):
            pkg.set_flags({"FLAGS_reqtrace": on})
            try:
                pkg.reqtrace.RECORDER.clear()
                clock = CountingClock()
                eng = pkg.make_engine(clock=clock)
                rids = [eng.add_request(prompt(i, 6), max_new_tokens=4)
                        for i in range(2)]
                eng.run_to_completion()
                reads[pkg.name, on] = clock.reads
                recorded = pkg.reqtrace.RECORDER.tail()
                assert bool(recorded) == on
                assert len(recorded) == (2 if on else 0)
                assert [tl["rid"] for tl in recorded] == (rids if on else [])
            finally:
                pkg.set_flags({"FLAGS_reqtrace": True})
                pkg.reqtrace.RECORDER.clear()
                pkg.reqtrace.EXEMPLARS.clear()
    assert reads["torch", False] == reads["jax", False]
    assert reads["torch", True] == reads["jax", True]
    assert reads["torch", False] < reads["torch", True]

    def boom():
        raise AssertionError("the disabled path read the clock")

    tpkg.set_flags({"FLAGS_reqtrace": False})
    try:
        saved, trt._now = trt._now, boom
        trt.record("s", 1, "submitted")
        trt.emit("s", boom, 1, "submitted")
        assert not trt.RECORDER.live_timelines()
    finally:
        trt._now = saved
        tpkg.set_flags({"FLAGS_reqtrace": True})
