"""The port's Router and TokenStream against the JAX package's.

The router drills of the JAX package's ``tests/test_serving_router.py``
(balancing, readiness rotation, a replica crashing mid-flight and its
requests re-routed with their tokens, streams across a re-route,
shedding at the router, drains) and its streaming tests run as
scenarios on both packages (``torch_serving_tier.run_both``); a router
and its replicas share one fake clock. The records must be equal: each
request's replica, retries, reroutes and sheds at the router, the
outcomes, ``stats()`` and ``health()``, the ``M_ROUTER_*`` and ``M_*``
metrics, the stream's tokens and status, and every timeline, event for
event; every router timeline must ``stitch`` with its replicas' and
pass ``validate()``.
"""
import pytest

from torch_serving_tier import FakeClock, packages, prompt, run_both


def tier(p, n=2, clock=None, **res_kw):
    clock = clock or FakeClock()
    reps = [p.make_engine(num_blocks=64, clock=clock, **res_kw)
            for _ in range(n)]
    return p.make_router(reps, clock=clock).warmup(), clock


def ref_greedy(p, prompt_ids, n_new):
    """A plain single-replica engine's completion."""
    eng = p.make_engine(num_blocks=64)
    rid = eng.add_request(prompt_ids, max_new_tokens=n_new)
    return eng.run_to_completion()[rid]


def assert_no_leaks(replicas):
    for rep in replicas:
        assert rep.bm.available == rep._total_usable
        assert all(s is None for s in rep.slots)


def stitched(p, router):
    """Every router timeline stitched with its replica legs: its events
    and ``validate()``'s findings (replica names by creation order)."""
    rec = p.reqtrace.RECORDER
    out = []
    for tl in rec.tail() + rec.live_timelines():
        if tl["scope"] != router.name:
            continue
        st = p.reqtrace.stitch(tl)
        assert p.reqtrace.validate(st) == [], st
        seg = p.reqtrace.segments(st)
        out.append((tl["rid"], [(e["event"], e["t"], e["scope"])
                                for e in st["events"]], seg))
    return sorted(out)


# ------------------------------------------------------------- routing
def balances_and_finishes(p):
    router, _ = tier(p)
    prompts = [prompt(i, n=4 + i) for i in range(6)]
    rids = [router.add_request(q, max_new_tokens=5) for q in prompts]
    router.run_to_completion()
    ocs = router.drain_outcomes()
    for rid, q in zip(rids, prompts):
        assert ocs[rid].status == p.RS.FINISHED
        assert ocs[rid].tokens == ref_greedy(p, q, 5)
    assert all(r["routed"] > 0 for r in router.stats()["per_replica"])
    assert_no_leaks(router.replicas)
    return [{rid: oc.tokens for rid, oc in ocs.items()}, stitched(p, router)]


def not_ready_replica_out_of_rotation(p):
    router, _ = tier(p)
    a = router.replicas[0]
    a.lifecycle.degrade("drill")
    rids = [router.add_request(prompt(i), max_new_tokens=3)
            for i in range(3)]
    router.run_to_completion()
    ocs = router.drain_outcomes()
    assert all(ocs[r].status == p.RS.FINISHED for r in rids)
    assert router.stats()["per_replica"][0]["routed"] == 0
    assert router.stats()["per_replica"][1]["routed"] == 3
    return stitched(p, router)


def degraded_mid_flight_reroutes(p):
    router, _ = tier(p)
    q = prompt(3, n=6)
    rid = router.add_request(q, max_new_tokens=8)
    router.step()
    rr = router._by_rid[rid]
    assert rr.replica_idx is not None
    victim = router.replicas[rr.replica_idx]
    with p.inject.armed("serving.crash_at_tick", tick=victim._ticks + 1):
        router.run_to_completion()
    oc = router.drain_outcomes()[rid]
    assert oc.status == p.RS.FINISHED
    assert oc.tokens == ref_greedy(p, q, 8)
    assert victim.lifecycle.state == p.ReplicaState.DEGRADED
    assert sum(r["rerouted_away"]
               for r in router.stats()["per_replica"]) >= 1
    assert_no_leaks(router.replicas)
    return [oc.tokens, oc.token_times, stitched(p, router)]


def stream_after_reroute_replays(p):
    router, _ = tier(p)
    q = prompt(8, n=6)
    rid = router.add_request(q, max_new_tokens=8)
    router.step()
    victim = router.replicas[router._by_rid[rid].replica_idx]
    with p.inject.armed("serving.crash_at_tick", tick=victim._ticks + 1):
        router.step()
    stream = router.stream(rid)
    toks = list(stream)
    assert toks == ref_greedy(p, q, 8)
    return [toks, stream.status, stitched(p, router)]


def all_overloaded_sheds_at_router(p):
    router, _ = tier(p, max_queue=2)
    reps = router.replicas
    fill = [router.add_request(prompt(10 + i), max_new_tokens=4)
            for i in range(4)]
    routed_before = [r["routed"] for r in router.stats()["per_replica"]]
    burst = [router.add_request(prompt(50 + i), max_new_tokens=4)
             for i in range(5)]
    ocs = {rid: router.outcomes[rid] for rid in burst}
    assert all(oc.status == p.RS.SHED for oc in ocs.values())
    assert all("router" in oc.detail for oc in ocs.values())
    assert router.shed_at_router == 5
    assert [r["routed"] for r in
            router.stats()["per_replica"]] == routed_before
    router.run_to_completion()
    ocs = router.drain_outcomes()
    for rid in fill:
        assert ocs[rid].status == p.RS.FINISHED
    for rep in reps:
        assert not any(oc.status == p.RS.SHED
                       for oc in rep.outcomes.values())
    assert_no_leaks(reps)
    return stitched(p, router)


def drain_during_streaming(p):
    router, _ = tier(p)
    q = prompt(4, n=6)
    rid = router.add_request(q, max_new_tokens=8)
    stream = router.stream(rid)
    first = next(stream)
    serving_rep = router.replicas[router._by_rid[rid].replica_idx]
    serving_rep.drain()
    rest = list(stream)
    assert stream.status == p.RS.FINISHED
    assert [first] + rest == ref_greedy(p, q, 8)
    assert serving_rep.lifecycle.state == p.ReplicaState.STOPPED
    assert_no_leaks(router.replicas)
    return [[first] + rest, stitched(p, router)]


def drain_before_admission_reroutes(p):
    router, _ = tier(p)
    reps = router.replicas
    p1, p2, p3 = prompt(5), prompt(6), prompt(7)
    reps[1].lifecycle.degrade("hold")
    r1 = router.add_request(p1, max_new_tokens=6)
    router.add_request(p2, max_new_tokens=6)
    r3 = router.add_request(p3, max_new_tokens=6)
    reps[1].recover()
    assert router._by_rid[r3].replica_idx == 0
    reps[0].drain()
    router.run_to_completion()
    ocs = router.drain_outcomes()
    assert ocs[r1].status == p.RS.FINISHED
    assert ocs[r3].status == p.RS.FINISHED
    assert ocs[r3].tokens == ref_greedy(p, p3, 6)
    assert router.stats()["per_replica"][0]["rerouted_away"] >= 1
    assert_no_leaks(reps)
    return stitched(p, router)


def router_drain_terminates_everything(p):
    router, _ = tier(p)
    rids = [router.add_request(prompt(20 + i), max_new_tokens=6)
            for i in range(5)]
    router.step()
    router.drain()
    ocs = router.drain_outcomes()
    for rid in rids:
        assert ocs[rid].status in p.TERMINAL
    assert_no_leaks(router.replicas)
    return stitched(p, router)


# ----------------------------------------------------------- streaming
def engine_stream_yields_all_tokens(p):
    q = prompt(60, n=7)
    eng = p.make_engine(num_blocks=64)
    rid = eng.add_request(q, max_new_tokens=8)
    s = eng.stream(rid)
    toks = list(s)
    assert toks == ref_greedy(p, q, 8)
    assert s.status == p.RS.FINISHED
    assert toks == eng.outcomes[rid].tokens
    return [toks, s.status]


def stream_attached_late_replays(p):
    q = prompt(61, n=6)
    eng = p.make_engine(num_blocks=64)
    rid = eng.add_request(q, max_new_tokens=8)
    eng.step()
    eng.step()
    s = eng.stream(rid)
    toks = list(s)
    assert toks == ref_greedy(p, q, 8)
    return [toks, s.status]


def stream_of_shed_request_is_empty(p):
    eng = p.make_engine(max_batch=1, max_queue=8, queue_high_water=1)
    rids = [eng.add_request(prompt(62 + i), max_new_tokens=4)
            for i in range(4)]
    s = eng.stream(rids[-1])
    eng.step()
    toks = list(s)
    assert toks == [] and s.status == p.RS.SHED
    eng.drain()
    return [toks, s.status]


def router_stream_matches_greedy(p):
    q = prompt(65, n=9)
    router, _ = tier(p)
    rid = router.add_request(q, max_new_tokens=8)
    s = router.stream(rid)
    toks = list(s)
    assert toks == ref_greedy(p, q, 8)
    return [toks, s.status, stitched(p, router)]


SCENARIOS = {f.__name__: f for f in (
    balances_and_finishes, not_ready_replica_out_of_rotation,
    degraded_mid_flight_reroutes, stream_after_reroute_replays,
    all_overloaded_sheds_at_router, drain_during_streaming,
    drain_before_admission_reroutes, router_drain_terminates_everything,
    engine_stream_yields_all_tokens, stream_attached_late_replays,
    stream_of_shed_request_is_empty, router_stream_matches_greedy)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    ref, got = run_both(SCENARIOS[name])
    assert got["returned"] == ref["returned"]
    assert got["routers"] == ref["routers"]
    assert got["engines"] == ref["engines"]
    assert got["timelines"] == ref["timelines"]
    assert got["metrics"] == ref["metrics"]


def test_router_refuses_a_replica_on_another_device():
    import types

    import torch

    from paddle_tpu_torch.serving import Router
    elsewhere = types.SimpleNamespace(device=torch.device("meta"))
    with pytest.raises(ValueError, match="a replica runs on meta"):
        Router([elsewhere], device="cpu")
