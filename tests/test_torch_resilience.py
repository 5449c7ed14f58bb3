"""The port's serving resilience against the JAX package's.

Every drill of the JAX package's ``tests/test_serving_resilience.py``
(admission race, crash at a tick and at the first tick, deadlines,
overload and shedding, the replica lifecycle, deadline-aware eviction,
the watchdog's wiring, the serving metrics) runs as one scenario on
both packages (``torch_serving_tier.run_both``): the scenario asserts
what the JAX test asserts, and the two records must be equal: statuses
and details, outcomes (tokens, ``submit_t``, ``first_token_t``,
``finish_t``, ``token_times`` under a fake clock that advances at every
read), ``health()``, the lifecycle history, the ``M_*`` metric values
and the request timelines, event for event. The disabled paths of the
metrics and of request tracing read no clock.
"""
import time

import pytest

from torch_serving_tier import (FakeClock, assert_quiesced, packages, prompt,
                                run_both)


# ---------------------------------------------------------- admission race
def admission_oom_requeues(p):
    eng = p.make_engine()
    r1 = eng.add_request(prompt(0), max_new_tokens=4)
    r2 = eng.add_request(prompt(1), max_new_tokens=4)
    with p.inject.armed("serving.admission_oom"):
        out = eng.step()          # must absorb the race, not raise
    assert isinstance(out, dict)
    assert eng.request_status(r1) in (p.RS.QUEUED, p.RS.RUNNING)
    out = eng.run_to_completion()
    assert set(out) == {r1, r2}
    assert len(out[r1]) == 4 and len(out[r2]) == 4
    assert_quiesced(p, eng, [r1, r2])
    assert eng.lifecycle.state == p.ReplicaState.READY
    return out


def head_of_line_memory_stall(p):
    eng = p.make_engine(max_batch=2, num_blocks=5, max_blocks_per_seq=4)
    rids = [eng.add_request(prompt(i, 4), max_new_tokens=6)
            for i in range(3)]
    out = eng.run_to_completion(max_ticks=300)
    assert all(len(out[r]) == 6 for r in rids)
    assert_quiesced(p, eng, rids)
    return out


# ---------------------------------------------------------------- crashes
def crash_fails_in_flight(p):
    eng = p.make_engine()
    r1 = eng.add_request(prompt(2), max_new_tokens=8)
    r2 = eng.add_request(prompt(3), max_new_tokens=8)
    eng.step()                                    # tick 1: admitted
    with p.inject.armed("serving.crash_at_tick", tick=2):
        out = eng.step()                          # tick 2: crashes
    assert out == {}
    assert eng.outcomes[r1].status == p.RS.FAILED
    assert eng.outcomes[r2].status == p.RS.FAILED
    assert "crash" in eng.outcomes[r1].detail
    assert eng.lifecycle.state == p.ReplicaState.DEGRADED
    assert eng.tick_failures == 1
    assert_quiesced(p, eng, [r1, r2])
    assert eng.health()["ready"] is False
    r3 = eng.add_request(prompt(4), max_new_tokens=3)
    out = eng.run_to_completion()
    assert len(out[r3]) == 3
    eng.recover()
    assert eng.lifecycle.state == p.ReplicaState.READY
    assert eng.health()["ready"] is True
    return out


def crash_at_first_tick(p):
    eng = p.make_engine()
    rid = eng.add_request(prompt(70), max_new_tokens=2)
    with p.inject.armed("serving.crash_at_tick", tick=1):
        out = eng.step()
    assert out == {}
    assert eng.lifecycle.state == p.ReplicaState.DEGRADED
    assert eng.request_status(rid) == p.RS.QUEUED
    out = eng.run_to_completion()
    assert len(out[rid]) == 2
    assert_quiesced(p, eng, [rid])
    return out


def kv_caches_reallocated_after_crash(p):
    eng = p.make_engine()
    r1 = eng.add_request(prompt(71), max_new_tokens=4)
    eng.step()
    assert any(bool(a.any()) for a in eng.kc)   # prefill wrote pages
    with p.inject.armed("serving.crash_at_tick"):
        eng.step()
    assert all(not bool(a.any()) for a in eng.kc + eng.vc)
    assert all(tuple(a.shape) == eng._kv_shape for a in eng.kc)
    r2 = eng.add_request(prompt(72), max_new_tokens=3)
    out = eng.run_to_completion()
    assert len(out[r2]) == 3
    assert_quiesced(p, eng, [r1, r2])
    return out


# -------------------------------------------------------------- deadlines
def ttft_deadline_expires_in_queue(p):
    clock = FakeClock()
    eng = p.make_engine(max_batch=1, clock=clock)
    busy = eng.add_request(prompt(5), max_new_tokens=6)
    eng.step()                     # busy owns the only slot
    late = eng.add_request(prompt(6), max_new_tokens=6,
                           ttft_deadline_s=5.0)
    clock.t = 6.0                  # past the TTFT deadline, no token
    eng.step()
    oc = eng.outcomes[late]
    assert oc.status == p.RS.DEADLINE_MISSED
    assert "TTFT" in oc.detail
    assert oc.tokens == []
    out = eng.run_to_completion()
    assert len(out[busy]) == 6
    assert_quiesced(p, eng, [busy, late])
    return out


def total_deadline_cancels_mid_flight(p):
    clock = FakeClock()
    eng = p.make_engine(max_batch=1, clock=clock)
    rid = eng.add_request(prompt(7), max_new_tokens=50, deadline_s=10.0)
    eng.step()
    eng.step()
    assert eng.request_status(rid) == p.RS.RUNNING
    assert eng._total_usable - eng.bm.available > 0
    clock.t = 11.0                 # expire mid-flight
    eng.step()
    oc = eng.outcomes[rid]
    assert oc.status == p.RS.DEADLINE_MISSED
    assert "total deadline" in oc.detail
    assert 0 < len(oc.tokens) < 50
    assert_quiesced(p, eng, [rid])


def default_deadlines_from_config(p):
    clock = FakeClock()
    eng = p.make_engine(max_batch=1, clock=clock, default_deadline_s=10.0)
    rid = eng.add_request(prompt(8), max_new_tokens=50)
    eng.step()
    clock.t = 11.0
    eng.step()
    assert eng.outcomes[rid].status == p.RS.DEADLINE_MISSED


# --------------------------------------------------------------- overload
def bounded_queue_raises_overloaded(p):
    eng = p.make_engine(max_batch=1, max_queue=2)
    eng.add_request(prompt(9), max_new_tokens=4)
    eng.add_request(prompt(10), max_new_tokens=4)
    with pytest.raises(p.Overloaded, match="queue full") as err:
        eng.add_request(prompt(11), max_new_tokens=4)
    out = eng.run_to_completion()
    assert len(out) == 2
    return [str(err.value), out]


def shed_past_high_water(p):
    eng = p.make_engine(max_batch=1, max_queue=16, queue_high_water=2)
    first = eng.add_request(prompt(12), max_new_tokens=4)
    eng.step()
    queued = [eng.add_request(prompt(13 + i), max_new_tokens=4)
              for i in range(4)]
    eng.step()                     # shed sweep: newest past mark go
    shed = [r for r in queued if eng.request_status(r) == p.RS.SHED]
    assert shed == queued[2:]      # newest shed, oldest kept
    for r in shed:
        assert "high-water" in eng.outcomes[r].detail
    out = eng.run_to_completion()
    assert set(out) == {first, *queued[:2]}
    assert_quiesced(p, eng, [first, *queued])
    return out


def shed_spares_preempted_partial_work(p):
    eng = p.make_engine(max_batch=1, max_queue=16, queue_high_water=1)
    first = eng.add_request(prompt(50), max_new_tokens=4)
    eng.step()
    a = eng.add_request(prompt(51), max_new_tokens=4)
    b = eng.add_request(prompt(52), max_new_tokens=4)   # newest
    eng.queue[-1].generated.append(7)   # simulate preempted progress
    eng.step()
    assert eng.request_status(a) == p.RS.SHED
    assert eng.request_status(b) != p.RS.SHED
    out = eng.run_to_completion()
    assert first in out and b in out
    assert_quiesced(p, eng, [first, a, b])
    return out


def burst_fills_slots_before_shedding(p):
    eng = p.make_engine(max_batch=4, max_queue=16, queue_high_water=1)
    rids = [eng.add_request(prompt(55 + i), max_new_tokens=2)
            for i in range(5)]
    out = eng.step()
    assert p.RS.SHED not in [eng.request_status(r) for r in rids]
    out.update(eng.run_to_completion())
    assert set(out) == set(rids)
    assert_quiesced(p, eng, rids)
    return out


def drain_outcomes_drops_rejected_mirror(p):
    eng = p.make_engine(max_batch=1, num_blocks=4, max_blocks_per_seq=2)
    bad = eng.add_request(list(range(1, 30)), max_new_tokens=4)
    assert bad in eng.rejected
    out = eng.drain_outcomes()
    assert out[bad].status == p.RS.FAILED
    assert bad not in eng.rejected
    return {rid: (oc.status, oc.detail) for rid, oc in out.items()}


# -------------------------------------------------------------- lifecycle
def warmup_walks_starting_warming_ready(p):
    eng = p.make_engine()
    assert eng.lifecycle.state == p.ReplicaState.STARTING
    assert eng.health()["ready"] is False
    eng.warmup()
    assert eng.lifecycle.state == p.ReplicaState.READY
    assert eng.health()["ready"] is True
    assert not eng.outcomes and not eng._done
    assert eng.bm.available == eng._total_usable
    states = [s for _, s, _ in eng.lifecycle.history]
    assert states == [p.ReplicaState.WARMING, p.ReplicaState.READY]


def warmup_with_pre_ready_traffic(p):
    eng = p.make_engine()
    early = eng.add_request(prompt(73), max_new_tokens=3)
    eng.warmup()
    assert eng.lifecycle.state == p.ReplicaState.READY
    out = eng.run_to_completion()
    assert len(out[early]) == 3
    assert eng.outcomes[early].status == p.RS.FINISHED
    assert_quiesced(p, eng, [early])
    return out


def warmup_ignores_default_deadlines(p):
    eng = p.make_engine(max_batch=1, default_ttft_deadline_s=1e-9,
                        default_deadline_s=1e-9)
    eng.warmup()
    assert eng.lifecycle.state == p.ReplicaState.READY
    assert not eng.outcomes


def first_step_flips_starting_to_ready(p):
    eng = p.make_engine()
    eng.add_request(prompt(20), max_new_tokens=2)
    eng.step()
    assert eng.lifecycle.state == p.ReplicaState.READY


def drain_finishes_in_flight_cancels_queued(p):
    eng = p.make_engine(max_batch=1)
    running = eng.add_request(prompt(21), max_new_tokens=6)
    eng.step()
    queued = [eng.add_request(prompt(22 + i), max_new_tokens=6)
              for i in range(2)]
    out = eng.drain()
    assert len(out[running]) == 6
    for r in queued:
        assert eng.outcomes[r].status == p.RS.CANCELLED
        assert "drained" in eng.outcomes[r].detail
    assert eng.lifecycle.state == p.ReplicaState.STOPPED
    assert eng.health()["live"] is False
    with pytest.raises(p.Overloaded, match="STOPPED"):
        eng.add_request(prompt(30))
    assert_quiesced(p, eng, [running, *queued])
    assert eng.drain() == {}
    return out


def drain_under_memory_pressure(p):
    eng = p.make_engine(max_batch=2, num_blocks=5, max_blocks_per_seq=4)
    r1 = eng.add_request(prompt(60, 4), max_new_tokens=6)
    r2 = eng.add_request(prompt(61, 4), max_new_tokens=6)
    eng.step()
    out = eng.drain(max_ticks=300)
    for r in (r1, r2):
        assert eng.outcomes[r].status in p.TERMINAL
    assert sorted(out) == [r1, r2]
    assert eng.lifecycle.state == p.ReplicaState.STOPPED
    assert_quiesced(p, eng, [r1, r2])
    return out


def cancel_queued_and_running(p):
    eng = p.make_engine(max_batch=1)
    running = eng.add_request(prompt(31), max_new_tokens=20)
    eng.step()
    queued = eng.add_request(prompt(32), max_new_tokens=4)
    assert eng.cancel(queued)
    assert eng.outcomes[queued].status == p.RS.CANCELLED
    assert eng.cancel(running)
    assert eng.outcomes[running].status == p.RS.CANCELLED
    assert eng.bm.available == eng._total_usable
    assert not eng.cancel(999)
    assert_quiesced(p, eng, [running, queued])


def invalid_transition_rejected(p):
    eng = p.make_engine()
    eng.drain()
    with pytest.raises(RuntimeError, match="invalid replica") as err:
        eng.lifecycle.to(p.ReplicaState.READY)
    return str(err.value)


# ------------------------------------------------ deadline-aware eviction
def preemption_picks_most_slack_victim(p):
    eng = p.make_engine(max_batch=2, num_blocks=5, max_blocks_per_seq=4)
    # r1 (older) has no deadline, r2 (younger) has one: the youngest-rid
    # rule would evict r2 and risk its deadline; the slack order evicts r1
    r1 = eng.add_request(prompt(33, 4), max_new_tokens=6)
    r2 = eng.add_request(prompt(34, 4), max_new_tokens=6, deadline_s=3600.0)
    evicted = None
    for _ in range(50):
        eng.step()
        if eng.queue:
            evicted = eng.queue[0].rid
            break
    assert evicted == r1
    out = eng.run_to_completion(max_ticks=300)
    assert len(out[r1]) == 6 and len(out[r2]) == 6
    assert_quiesced(p, eng, [r1, r2])
    return out


# ------------------------------------------------------- watchdog wiring
def watchdog_quiet_then_stall_degrades(p):
    # a clock held still: the watchdog's thread reads it too. A timeout
    # of 1 s (the JAX test's is 0.15 s): an eager CPU tick of the port on
    # a loaded test host can take longer than 0.15 s
    eng = p.make_engine(clock=FakeClock(step=0.0))
    eng.warmup(prompt_len=5, max_new_tokens=6)
    hangs = []
    wd = p.Watchdog(timeout=1.0, poll_interval=0.05,
                    on_hang=lambda w: hangs.append(w.timeout)).start()
    try:
        eng.attach_watchdog(wd)
        rid = eng.add_request(prompt(35), max_new_tokens=6)
        out = eng.run_to_completion()
        assert len(out[rid]) == 6
        time.sleep(1.2)            # idle engine: no work in flight
        assert wd.hang_count == 0 and not hangs
        assert eng.lifecycle.state == p.ReplicaState.READY
        r2 = eng.add_request(prompt(36), max_new_tokens=2)
        with p.inject.armed("serving.tick_stall", seconds=2.0):
            out.update(eng.step())  # stalls inside the tick, no raise
        assert wd.hang_count >= 1
        assert hangs
        assert eng.lifecycle.state == p.ReplicaState.DEGRADED
        out.update(eng.run_to_completion())
        assert len(out[r2]) == 2
        assert_quiesced(p, eng, [r2])
    finally:
        wd.stop()
    return out


def end_work_underflow_guard(p):
    wd = p.Watchdog(timeout=60.0)
    wd.end_work()
    assert wd._in_flight == 0 and wd.unbalanced_end_count == 1
    wd.begin_work()
    assert wd._in_flight == 1
    wd.end_work()
    assert wd._in_flight == 0 and wd.unbalanced_end_count == 1


# ----------------------------------------------------------------- metrics
def serving_metrics_recorded(p):
    eng = p.make_engine(max_batch=1, max_queue=16, queue_high_water=1)
    rids = [eng.add_request(prompt(40 + i), max_new_tokens=3)
            for i in range(4)]
    eng.run_to_completion()
    reg = p.REGISTRY
    assert reg.get("paddle_tpu_serving_admitted").total() >= 1
    assert reg.get("paddle_tpu_serving_shed").total() >= 1
    assert reg.get("paddle_tpu_serving_ttft_seconds").total_count() >= 1
    assert reg.get("paddle_tpu_serving_itl_seconds").total_count() >= 1
    assert reg.get("paddle_tpu_serving_tick_seconds").total_count() >= 1
    assert reg.get("paddle_tpu_serving_kv_blocks_in_use").value() == 0.0
    by_outcome = reg.get("paddle_tpu_serving_requests")
    assert by_outcome.value(outcome="FINISHED") >= 1
    assert by_outcome.value(outcome="SHED") >= 1
    state = reg.get("paddle_tpu_serving_replica_state")
    assert state.value() == p.ReplicaState.ORDER.index(p.ReplicaState.READY)
    assert_quiesced(p, eng, rids)


def speculative_and_budgeted_timelines(p):
    """The speculative verify's and the prefill budget's events
    (``spec_verify``, ``prefill_deferred``) and the spec metrics."""
    eng = p.make_engine(max_batch=2, engine_kw=dict(
        speculate="ngram", speculate_k=3,
        scheduler=p.SchedulerConfig(prefill_token_budget=4)))
    rids = [eng.add_request(prompt(80 + i, 6) * 3, max_new_tokens=9)
            for i in range(3)]
    out = eng.run_to_completion()
    assert eng.spec_proposed > 0 and eng.scheduler.deferred_chunks > 0
    assert_quiesced(p, eng, rids)
    return [out, eng.spec_proposed, eng.spec_accepted]


SCENARIOS = {f.__name__: f for f in (
    admission_oom_requeues, head_of_line_memory_stall,
    crash_fails_in_flight, crash_at_first_tick,
    kv_caches_reallocated_after_crash, ttft_deadline_expires_in_queue,
    total_deadline_cancels_mid_flight, default_deadlines_from_config,
    bounded_queue_raises_overloaded, shed_past_high_water,
    shed_spares_preempted_partial_work, burst_fills_slots_before_shedding,
    drain_outcomes_drops_rejected_mirror,
    warmup_walks_starting_warming_ready, warmup_with_pre_ready_traffic,
    warmup_ignores_default_deadlines, first_step_flips_starting_to_ready,
    drain_finishes_in_flight_cancels_queued, drain_under_memory_pressure,
    cancel_queued_and_running, invalid_transition_rejected,
    preemption_picks_most_slack_victim, watchdog_quiet_then_stall_degrades,
    end_work_underflow_guard, serving_metrics_recorded,
    speculative_and_budgeted_timelines)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    ref, got = run_both(SCENARIOS[name])
    assert got["returned"] == ref["returned"]
    assert got["engines"] == ref["engines"]
    assert got["timelines"] == ref["timelines"]
    assert got["exemplars"] == ref["exemplars"]
    assert got["metrics"] == ref["metrics"]


def test_contained_failure_is_kept_and_logged(caplog):
    """The FAILED detail is the JAX engine's (``tick N failed:
    InjectedFault(...)``); the engine keeps the exception, which names
    its fault point, and logs its traceback."""
    _, tside = packages()
    eng = tside.make_engine()
    rid = eng.add_request(prompt(2), max_new_tokens=4)
    eng.step()
    with tside.inject.armed("serving.crash_at_tick", tick=2):
        eng.step()
    assert eng.outcomes[rid].detail == (
        "tick 2 failed: InjectedFault('injected crash at tick 2')")
    assert isinstance(eng.last_tick_failure, tside.inject.InjectedFault)
    assert eng.last_tick_failure.point == "serving.crash_at_tick"
    logged = [r for r in caplog.records if r.levelname == "ERROR"]
    assert len(logged) == 1 and logged[0].exc_info[0] is \
        tside.inject.InjectedFault


def test_config_validation_matches_jax():
    from paddle_tpu.inference import ResilienceConfig as JaxConfig
    from paddle_tpu_torch.inference import ResilienceConfig
    for kw in (dict(max_queue=0), dict(queue_high_water=-1),
               dict(max_queue=4, queue_high_water=5), dict(slo_target=1.0),
               dict(slo_fast_window_s=0.0),
               dict(slo_fast_window_s=700.0, slo_slow_window_s=600.0)):
        with pytest.raises(ValueError) as want:
            JaxConfig(**kw)
        with pytest.raises(ValueError) as got:
            ResilienceConfig(**kw)
        assert str(got.value) == str(want.value)


def test_disabled_paths_read_no_clock():
    """With FLAGS_reqtrace and FLAGS_enable_metrics off, a whole engine
    run through the port reads the engine's clock only where the JAX
    engine does without them (submit, terminal, token times), never in
    request tracing or metrics: ``emit`` is handed a clock that raises."""
    import paddle_tpu_torch as tpkg
    from paddle_tpu_torch.observability import metrics, reqtrace

    def boom():
        raise AssertionError("a disabled path read the clock")

    tpkg.set_flags({"FLAGS_reqtrace": False, "FLAGS_enable_metrics": False})
    try:
        reqtrace.emit("scope", boom, 1, "submitted")
        reqtrace.record("scope", 1, "submitted")
        metrics.histogram("paddle_tpu_test_clock_free").observe(1.0)
        _, tside = packages()
        eng = tside.make_engine()
        eng._rt_event = lambda rid, ev, t=None, **m: reqtrace.emit(
            "x", boom, rid, ev, t, **m)
        rid = eng.add_request(prompt(3), max_new_tokens=3)
        assert len(eng.run_to_completion()[rid]) == 3
        assert reqtrace.RECORDER.timeline("x", rid) is None
    finally:
        tpkg.set_flags({"FLAGS_reqtrace": True})
