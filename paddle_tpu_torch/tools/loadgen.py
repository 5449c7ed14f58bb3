"""Open-loop Poisson load harness for the paged serving engine
(counterpart of the JAX package's ``tools/loadgen.py``).

Open-loop means arrivals are driven by a Poisson process fixed up front —
the generator does NOT wait for completions before submitting (a
closed-loop harness hides overload by self-throttling; see the
coordinated-omission literature). The engine is ticked between arrivals;
every submitted request ends in a terminal status, and the report
aggregates the SLO view of the run:

* p50/p99 TTFT (submit → first token) and inter-token latency,
* goodput (tokens/s from FINISHED requests) vs offered load,
* shed / deadline-missed / failed / cancelled counts and submit-time
  ``Overloaded`` backpressure rejections.

Library: ``run_load(engine, offered_rps=..., n_requests=...)`` → dict;
``engine`` is a ``PagedEngine`` or a ``Router``, and ``device`` (default
the card; ``device="cpu"`` asks for the CPU) must be where it runs.
CLI (tiny Llama, sweeps offered load, one JSON line per point):

    python -m paddle_tpu_torch.tools.loadgen --rates 4,16,64 --requests 32
    python -m paddle_tpu_torch.tools.loadgen --device cpu --replicas 2
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..core.place import DeviceLike, resolve_device


def _percentile(xs: List[float], q: float) -> Optional[float]:
    if not xs:
        return None
    return float(np.percentile(np.asarray(xs, np.float64), q))


def poisson_arrivals(offered_rps: float, n: int, seed: int = 0):
    """Cumulative arrival times (seconds from start) of a Poisson process
    with rate ``offered_rps`` — exponential inter-arrivals, seeded."""
    if offered_rps <= 0:
        raise ValueError("offered_rps must be > 0")
    rng = np.random.RandomState(seed)
    return np.cumsum(rng.exponential(1.0 / offered_rps, size=n))


def run_load(engine, *, offered_rps: float, n_requests: int,
             vocab_size: int = 97,
             prompt_len_range=(4, 24), max_new_tokens: int = 8,
             ttft_deadline_s: Optional[float] = None,
             deadline_s: Optional[float] = None,
             seed: int = 0,
             make_prompt: Optional[Callable[[np.random.RandomState, int],
                                            List[int]]] = None,
             clock: Callable[[], float] = time.monotonic,
             max_wall_s: float = 300.0,
             attribution: bool = True,
             trace_out: Optional[str] = None,
             trace_worst_k: int = 4,
             device: DeviceLike = None) -> dict:
    """Drive ``engine`` with an open-loop Poisson arrival stream and
    return the latency/goodput/outcome report (JSON-able dict).

    The engine is ticked whenever it has work; between arrivals with an
    idle engine the harness sleeps in small slices so arrival timing
    stays honest. ``max_wall_s`` is a harness-level backstop (an engine
    bug must fail the drill, not hang it).

    With ``attribution`` (default) the run collects the engine's
    per-program spans (``serving.prefill`` / ``serving.decode``, each
    ending in the blocking copy of its result to the host) and reports
    their attribution: prefill vs decode seconds and shares, plus
    seconds per tick. On the card a span covers the host's launches and
    the card's time together, so ``device_util_of_wall`` is the share of
    the wall inside programs, not the card's busy share (a profiler
    measures that). Skipped when another recording already owns the
    span buffer.

    With ``FLAGS_reqtrace`` on (the default) the report also carries
    the p99-TTFT exemplar's wall-segment decomposition
    (``queue/prefill/decode/preempted/rerouted``, summing to its total)
    so a bad percentile points at a concrete request; ``trace_out``
    names a path PREFIX under which the worst-``trace_worst_k``
    request timelines are exported as a chrome trace merged with the
    run's device spans (``<prefix>.trace.json``) plus the raw timelines
    (``<prefix>.reqtrace.json``) — see ``tools/request_trace.py``."""
    from ..inference import Overloaded
    from ..observability import trace as _trace

    dev = resolve_device(device)
    if engine.device.type != dev.type:
        raise ValueError(f"the engine runs on {engine.device}, run_load "
                         f"was asked for {dev}")

    own_trace = attribution and not _trace.active()
    if own_trace:
        _trace.clear()
        _trace.activate()

    rng = np.random.RandomState(seed)
    arrivals = poisson_arrivals(offered_rps, n_requests, seed=seed)
    lo, hi = prompt_len_range
    if make_prompt is None:
        def make_prompt(r, i):
            return [int(t) for t in
                    r.randint(1, vocab_size, size=int(r.randint(lo, hi + 1)))]
    prompts = [make_prompt(rng, i) for i in range(n_requests)]

    start = clock()
    real_start = time.monotonic()
    rids: List[int] = []
    overloaded = 0
    i = 0
    try:
        while i < n_requests or engine.has_work():
            now = clock() - start
            # the backstop runs on REAL time: an injected non-advancing
            # clock must still fail the drill rather than hang it
            if time.monotonic() - real_start > max_wall_s:
                raise RuntimeError(
                    f"loadgen exceeded max_wall_s={max_wall_s} with "
                    f"{n_requests - i} arrivals pending")
            while i < n_requests and arrivals[i] <= now:
                try:
                    rids.append(engine.add_request(
                        prompts[i], max_new_tokens=max_new_tokens,
                        ttft_deadline_s=ttft_deadline_s,
                        deadline_s=deadline_s))
                except Overloaded:
                    overloaded += 1
                i += 1
            if engine.has_work():
                engine.step()
            elif i < n_requests:
                time.sleep(min(max(arrivals[i] - now, 0.0), 0.005))
    finally:
        # a failed drill must not leave the global span buffer recording
        if own_trace:
            _trace.deactivate()
    wall = clock() - start
    # span timestamps are perf_counter seconds — utilization must divide
    # by REAL elapsed time, not an injected drill clock
    real_wall = time.monotonic() - real_start

    device = None
    spans = []
    if own_trace:
        spans = _trace.drain()
        ticks = sum(1 for _n, cat, *_ in spans if cat == "serving")
        phase_s = {"prefill": 0.0, "decode": 0.0}
        for name, cat, t0, t1, _tid, _args in spans:
            if cat == "device" and name.startswith("serving."):
                phase = name.split(".", 1)[1]
                if phase in phase_s:
                    phase_s[phase] += t1 - t0
        dev_total = phase_s["prefill"] + phase_s["decode"]
        device = {
            "ticks": ticks,
            "prefill_compute_s": round(phase_s["prefill"], 4),
            "decode_compute_s": round(phase_s["decode"], 4),
            "device_s": round(dev_total, 4),
            "prefill_compute_share": round(
                phase_s["prefill"] / dev_total, 4) if dev_total else None,
            "decode_compute_share": round(
                phase_s["decode"] / dev_total, 4) if dev_total else None,
            "device_s_per_tick": round(dev_total / ticks, 6) if ticks
            else None,
            "device_util_of_wall": round(dev_total / real_wall, 4)
            if real_wall > 0 else None,
        }

    outcomes = engine.drain_outcomes()
    missing = [r for r in rids if r not in outcomes]
    if missing:
        raise RuntimeError(
            f"loadgen invariant violated: {len(missing)} submitted "
            f"request(s) have no terminal outcome: {missing[:5]}")

    by_status: Dict[str, int] = {}
    ttfts: List[float] = []
    itls: List[float] = []
    good_tokens = 0
    for rid in rids:
        oc = outcomes[rid]
        by_status[oc.status] = by_status.get(oc.status, 0) + 1
        if oc.ttft is not None:
            ttfts.append(oc.ttft)
        itls.extend(oc.itls)
        if oc.status == "FINISHED":
            good_tokens += len(oc.tokens)

    finished = by_status.get("FINISHED", 0)

    # ---- request-trace view: p99 exemplar decomposition + worst-k
    # timeline export (reqtrace is FLAGS-gated; both degrade to None) --
    p99_exemplar = None
    scope = getattr(engine, "reqtrace_scope", None)
    if scope is not None:
        from ..observability import reqtrace as _rt
        from . import request_trace as _rt_tool

        src = _rt_tool.TimelineSource()
        with_ttft = sorted(
            ((outcomes[r].ttft, r) for r in rids
             if outcomes[r].ttft is not None),
            key=lambda p: p[0])
        if with_ttft:
            p99_t, p99_rid = with_ttft[
                min(int(round(0.99 * (len(with_ttft) - 1))),
                    len(with_ttft) - 1)]
            tl = src.resolve(scope, p99_rid)
            if tl is not None:
                seg = _rt.segments(tl)
                p99_exemplar = {
                    "rid": p99_rid, "ttft_s": round(p99_t, 6),
                    "outcome": outcomes[p99_rid].status,
                    "segments_s": {b: round(seg[b], 6)
                                   for b in _rt.SEGMENT_BUCKETS},
                    "total_s": round(seg["total"], 6),
                    "complete": seg["complete"],
                }
        if trace_out:
            import os as _os
            d = _os.path.dirname(trace_out)
            if d:
                _os.makedirs(d, exist_ok=True)
            # worst-k by TTFT, padded with the longest-wall outcomes
            # (an all-shed point has no TTFTs but still needs evidence)
            ranked = [r for _, r in reversed(with_ttft)]
            if len(ranked) < trace_worst_k:
                seen = set(ranked)
                by_wall = sorted(
                    rids, key=lambda r: -((outcomes[r].finish_t or 0.0)
                                          - (outcomes[r].submit_t
                                             or 0.0)))
                ranked.extend(r for r in by_wall if r not in seen)
            worst = [tl for tl in
                     (src.resolve(scope, r)
                      for r in ranked[:trace_worst_k]) if tl]
            _rt_tool.export(f"{trace_out}.trace.json", worst,
                            spans=_rt_tool.serving_spans(spans))
            with open(f"{trace_out}.reqtrace.json", "w") as f:
                import json as _json
                _json.dump({"format": "paddle_tpu.reqtrace/1",
                            "reason": "loadgen --trace-out",
                            "timelines": worst}, f)

    # router mode: per-replica routing/goodput breakdown rides the report
    router = engine.stats() if hasattr(engine, "stats") else None
    return {
        "offered_rps": float(offered_rps),
        "achieved_arrival_rps": round(n_requests / max(wall, 1e-9), 3),
        "n_requests": int(n_requests),
        "submitted": len(rids),
        "overloaded": int(overloaded),
        "outcomes": by_status,
        "shed": by_status.get("SHED", 0),
        "deadline_missed": by_status.get("DEADLINE_MISSED", 0),
        "failed": by_status.get("FAILED", 0),
        "cancelled": by_status.get("CANCELLED", 0),
        "finished": finished,
        "goodput_tokens_per_sec": round(good_tokens / max(wall, 1e-9), 2),
        "goodput_requests_per_sec": round(finished / max(wall, 1e-9), 3),
        "p50_ttft_s": _percentile(ttfts, 50),
        "p99_ttft_s": _percentile(ttfts, 99),
        "p50_itl_s": _percentile(itls, 50),
        "p99_itl_s": _percentile(itls, 99),
        "wall_s": round(wall, 3),
        "device_attribution": device,
        "p99_ttft_exemplar": p99_exemplar,
        "router": router,
    }


_MODEL_CACHE: dict = {}


def _tiny_model(seed=7, device: DeviceLike = None):
    """One shared tiny Llama per (seed, device): the replicas of a
    router share one model, each with its own KV pool."""
    key = (seed, str(resolve_device(device)))
    if key not in _MODEL_CACHE:
        from ..models import LlamaConfig, LlamaForCausalLM

        cfg = LlamaConfig(vocab_size=97, hidden_size=64,
                          intermediate_size=128, num_layers=2, num_heads=4,
                          max_seq_len=256, use_flash_attention=False)
        _MODEL_CACHE[key] = LlamaForCausalLM(cfg, device=device,
                                             seed=seed).eval()
    return _MODEL_CACHE[key]


def _tiny_engine(max_batch=4, max_queue=32, high_water=None, seed=7,
                 kv_dtype=None, speculate=None, prefill_budget=None,
                 device: DeviceLike = None):
    """Tiny Llama replica for CLI runs and drills (per-request deadlines
    are passed through run_load, not the engine defaults)."""
    from ..inference import PagedEngine, ResilienceConfig
    from ..serving import SchedulerConfig

    rcfg = ResilienceConfig(max_queue=max_queue,
                            queue_high_water=high_water)
    sched = (SchedulerConfig(prefill_token_budget=prefill_budget)
             if prefill_budget else None)
    return PagedEngine(_tiny_model(seed, device), max_batch=max_batch,
                       block_size=8, num_blocks=128, max_blocks_per_seq=16,
                       kv_dtype=kv_dtype, speculate=speculate,
                       scheduler=sched, resilience=rcfg, device=device)


def _tiny_tier(replicas, **engine_kw):
    """R replicas behind a Router. Shedding policy lives AT THE ROUTER:
    replicas keep their bounded queues (Overloaded bounces the router to
    the next candidate) but run without an internal high-water mark —
    overload becomes router-level SHED outcomes, never replica-side
    drops."""
    from ..serving import Router

    engine_kw.pop("high_water", None)
    reps = [_tiny_engine(high_water=None, **engine_kw)
            for _ in range(replicas)]
    return Router(reps, device=engine_kw.get("device")).warmup()


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rates", default="4,16,64",
                    help="comma-separated offered loads (requests/s)")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-queue", type=int, default=32)
    ap.add_argument("--high-water", type=int, default=None)
    ap.add_argument("--ttft-deadline-s", type=float, default=None)
    ap.add_argument("--deadline-s", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=1,
                    help="router mode: front R replicas with the serving "
                         "router (shed at the router, per-replica "
                         "goodput breakdown in the report)")
    ap.add_argument("--kv-dtype", default=None,
                    help='e.g. "int8" for the quantized KV page pool')
    ap.add_argument("--speculate", default=None,
                    help='"ngram" enables speculative decoding')
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="phase-split scheduler: prefill tokens per tick")
    ap.add_argument("--trace-out", default=None, metavar="DIR",
                    help="export the worst-k request timelines per "
                         "curve point (chrome trace merged with device "
                         "spans + raw timelines) under DIR; the summary "
                         "line always carries the p99 TTFT exemplar's "
                         "segment decomposition")
    ap.add_argument("--trace-worst-k", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help='"cpu" to run on the CPU (default: the card)')
    args = ap.parse_args(argv)

    engine_kw = dict(max_batch=args.max_batch, max_queue=args.max_queue,
                     kv_dtype=args.kv_dtype, speculate=args.speculate,
                     prefill_budget=args.prefill_budget, device=args.device)
    for rate in [float(r) for r in args.rates.split(",") if r]:
        if args.replicas > 1:
            eng = _tiny_tier(args.replicas, **engine_kw)
        else:
            eng = _tiny_engine(high_water=args.high_water, **engine_kw)
            eng.warmup()
        trace_out = None
        if args.trace_out:
            import os
            trace_out = os.path.join(args.trace_out, f"rate_{rate:g}")
        report = run_load(
            eng, offered_rps=rate, n_requests=args.requests,
            max_new_tokens=args.max_new_tokens,
            ttft_deadline_s=args.ttft_deadline_s,
            deadline_s=args.deadline_s, seed=args.seed,
            trace_out=trace_out, trace_worst_k=args.trace_worst_k,
            device=args.device)
        report["replicas"] = args.replicas
        eng.drain()
        print(json.dumps(report))


if __name__ == "__main__":
    main()
