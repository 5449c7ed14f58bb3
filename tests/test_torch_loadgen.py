"""The port's open-loop load harness against the JAX package's.

``run_load`` of each package drives its engine, or a router of two, with
the same seeded Poisson arrivals and prompts; the harness and the
engines read one fake clock that advances at every read, so every
clock-driven field of the report must be equal: outcome counts,
goodput, the TTFT and inter-token-latency percentiles, the wall, the
router's breakdown and the p99-TTFT exemplar's segments (only
``device_attribution``, which is host time, is left out). So must the
engines' records (``torch_serving_tier``) and the worst-k timelines that
``trace_out`` exports.
"""
import json

import numpy as np
import pytest

import paddle_tpu_torch.tools.loadgen as tloadgen
import tools.loadgen as jloadgen
from torch_serving_tier import FakeClock, Names, run_both

LOADGEN = {"jax": (jloadgen, {}), "torch": (tloadgen, {"device": "cpu"})}


def run_load(p, engine, clock, **kw):
    mod, dev = LOADGEN[p.name]
    report = mod.run_load(engine, clock=clock, max_wall_s=120.0,
                          vocab_size=97, **kw, **dev)
    assert report.pop("device_attribution")["ticks"] > 0
    return report


def open_loop_report(p):
    clock = FakeClock()
    eng = p.make_engine(max_batch=2, num_blocks=64, max_queue=64,
                        queue_high_water=32, clock=clock)
    eng.warmup()
    report = run_load(p, eng, clock, offered_rps=200.0, n_requests=10,
                      prompt_len_range=(3, 8), max_new_tokens=4, seed=5)
    assert report["submitted"] + report["overloaded"] == 10
    assert report["finished"] >= 1 and report["goodput_tokens_per_sec"] > 0
    assert report["p50_ttft_s"] > 0 and report["p99_ttft_s"] > 0
    assert report["p50_itl_s"] > 0
    assert sum(report["outcomes"].values()) == report["submitted"]
    assert report["p99_ttft_exemplar"]["complete"]
    assert not eng.outcomes and eng.bm.available == eng._total_usable
    eng.drain()
    assert eng.lifecycle.state == p.ReplicaState.STOPPED
    return report


def deadlines_account_every_request(p):
    clock = FakeClock()
    eng = p.make_engine(max_batch=1, max_queue=4, queue_high_water=2,
                        clock=clock)
    report = run_load(p, eng, clock, offered_rps=500.0, n_requests=12,
                      prompt_len_range=(3, 6), max_new_tokens=6,
                      ttft_deadline_s=0.005, deadline_s=0.02, seed=9)
    assert sum(report["outcomes"].values()) == report["submitted"]
    assert report["submitted"] + report["overloaded"] == 12
    assert report["deadline_missed"] + report["shed"] \
        + report["overloaded"] > 0          # something had to give
    assert eng.bm.available == eng._total_usable
    return report


def router_accounts_everything(p):
    clock = FakeClock()
    reps = [p.make_engine(max_batch=2, num_blocks=64, max_queue=4,
                          clock=clock) for _ in range(2)]
    router = p.make_router(reps, clock=clock).warmup()
    report = run_load(p, router, clock, offered_rps=500.0, n_requests=12,
                      prompt_len_range=(4, 10), max_new_tokens=4, seed=3)
    router.drain()
    assert report["submitted"] == 12 and report["overloaded"] == 0
    assert report["finished"] + report["shed"] == 12
    routed = sum(r["routed"] for r in report["router"]["per_replica"])
    assert routed + report["router"]["shed_at_router"] >= 12
    for rep in reps:
        assert rep.bm.available == rep._total_usable
    return report


def saturated_router_sheds_at_the_router(p):
    """The router rung's burst shape: bounded replica queues, no
    replica-side high-water mark, an instantaneous burst."""
    clock = FakeClock()
    reps = [p.make_engine(max_batch=2, num_blocks=64, max_queue=2,
                          clock=clock) for _ in range(2)]
    router = p.make_router(reps, clock=clock).warmup()
    report = run_load(p, router, clock, offered_rps=10_000.0, n_requests=24,
                      prompt_len_range=(4, 10), max_new_tokens=4, seed=4,
                      ttft_deadline_s=0.5, deadline_s=1.0)
    router.drain()
    assert report["router"]["shed_at_router"] > 0
    assert report["shed"] == report["router"]["shed_at_router"]
    return report


SCENARIOS = {f.__name__: f for f in (
    open_loop_report, deadlines_account_every_request,
    router_accounts_everything, saturated_router_sheds_at_the_router)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_run_load_matches_jax(name):
    ref, got = run_both(SCENARIOS[name])
    assert got["returned"] == ref["returned"]
    assert got["engines"] == ref["engines"]
    assert got["routers"] == ref["routers"]
    assert got["timelines"] == ref["timelines"]
    assert got["metrics"] == ref["metrics"]


@pytest.mark.parametrize("rate,n,seed", [(100.0, 20, 3), (7.5, 50, 0)])
def test_poisson_arrivals_match_jax(rate, n, seed):
    got = tloadgen.poisson_arrivals(rate, n, seed=seed)
    np.testing.assert_array_equal(got, jloadgen.poisson_arrivals(rate, n,
                                                                 seed=seed))
    assert len(got) == n and np.all(np.diff(got) > 0)
    for mod in (jloadgen, tloadgen):
        with pytest.raises(ValueError, match="offered_rps"):
            mod.poisson_arrivals(0.0, 3)


def test_trace_out_exports_match_jax(tmp_path):
    """The worst-k raw timelines are equal; in the chrome trace the
    request lanes are equal (the span lanes carry host times)."""
    def scenario(p):
        clock = FakeClock()
        eng = p.make_engine(max_batch=2, num_blocks=64, clock=clock)
        eng.warmup()
        prefix = str(tmp_path / p.name / "rate")
        run_load(p, eng, clock, offered_rps=300.0, n_requests=8,
                 prompt_len_range=(3, 8), max_new_tokens=3, seed=2,
                 trace_out=prefix, trace_worst_k=3)
        names = Names(p)
        with open(prefix + ".reqtrace.json") as f:
            raw = names(json.load(f))
        with open(prefix + ".trace.json") as f:
            lanes = [e for e in json.load(f)["traceEvents"]
                     if e.get("pid") == 1]
        assert len(raw["timelines"]) == 3
        return [raw, names(lanes)]

    ref, got = run_both(scenario)
    assert got["returned"] == ref["returned"]


def test_run_load_refuses_an_engine_on_another_device():
    import types

    import torch
    elsewhere = types.SimpleNamespace(device=torch.device("meta"))
    with pytest.raises(ValueError, match="the engine runs on meta"):
        tloadgen.run_load(elsewhere, offered_rps=1.0, n_requests=1,
                          device="cpu")
