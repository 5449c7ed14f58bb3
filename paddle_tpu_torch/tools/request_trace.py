"""Render serving request timelines: waterfalls + chrome-trace lanes
(counterpart of the JAX package's ``tools/request_trace.py``).

The request flight recorder (``paddle_tpu_torch/observability/reqtrace.py``)
answers *why request 4711 took 900 ms*; this tool renders the answer two
ways:

* **terminal waterfall** — one request's lifecycle events with relative
  timestamps, inter-event deltas and cause metadata, followed by its
  exact ``queue / prefill / decode / preempted / rerouted`` wall-segment
  decomposition (the per-request analogue of ``tools/perf_report.py``'s
  step attribution);
* **chrome trace** — one lane per request whose bars ARE the segment
  intervals (plus instant marks for every raw event), merged on one
  clock with the engine's device spans (``serving.tick`` host spans and
  the blocking-read-bracketed ``serving.{prefill,decode}`` device
  spans) so "my request sat in queue" lines up against "the chip was
  busy prefilling someone else's prompt". Both reqtrace timestamps and
  span timestamps are monotonic-clock seconds (one epoch on Linux), so
  the merge needs no offset arithmetic. On the card the program spans
  end in the blocking copy of their results, so they cover the host's
  launches and the card's time together.

Inputs: a reqtrace dump (``PADDLE_TPU_REQTRACE=/path`` → ``/path.r0``;
the watchdog writes one from the hang path too), or the live process
recorder when used as a library (``loadgen.run_load(trace_out=...)``
rides this module per curve point). Router-scope timelines are stitched
with their replica legs through the ``routed`` events before rendering.

CLI::

    # worst-k TTFT exemplars from a dump, waterfalls + merged trace
    python -m paddle_tpu_torch.tools.request_trace \
        --dump reqtrace.json.r0 --worst 3 --out merged_trace.json

    # one specific request, merging the profiler's chrome trace
    python -m paddle_tpu_torch.tools.request_trace \
        --dump reqtrace.json.r0 --scope router0 --rid 17 \
        --merge-trace worker_r0_host_ops.json
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple


def _reqtrace():
    from ..observability import reqtrace
    return reqtrace


# ---------------------------------------------------------------------------
# Timeline selection (live recorder or dump payload)
# ---------------------------------------------------------------------------
class TimelineSource:
    """Uniform lookup over a dump payload or the live process recorder."""

    def __init__(self, payload: Optional[dict] = None):
        self._payload = payload
        self._index: Dict[Tuple[str, int], dict] = {}
        if payload is not None:
            for tl in payload.get("timelines", ()):
                self._index[(tl["scope"], int(tl["rid"]))] = tl

    def lookup(self, scope: str, rid: int) -> Optional[dict]:
        if self._payload is not None:
            return self._index.get((str(scope), int(rid)))
        return _reqtrace().RECORDER.timeline(scope, rid)

    def timelines(self) -> List[dict]:
        if self._payload is not None:
            return list(self._payload.get("timelines", ()))
        rt = _reqtrace()
        return rt.RECORDER.tail() + rt.RECORDER.live_timelines()

    def exemplars(self, kind: str = "ttft") -> List[dict]:
        if self._payload is not None:
            return list(
                (self._payload.get("exemplars") or {}).get(kind, ()))
        return _reqtrace().EXEMPLARS.worst(kind)

    def resolve(self, scope: str, rid: int) -> Optional[dict]:
        """Timeline for (scope, rid), stitched with replica legs when it
        is a router-scope timeline (detected by ``routed`` events)."""
        tl = self.lookup(scope, rid)
        if tl is None:
            return None
        if any(e["event"] == "routed" for e in tl.get("events", ())):
            tl = _reqtrace().stitch(tl, lookup=self.lookup)
        return tl

    def worst(self, k: int = 4, kind: str = "ttft") -> List[dict]:
        """Stitched timelines of the worst-k ``kind`` exemplars (falls
        back to the slowest total-wall timelines when no exemplars were
        recorded, e.g. an all-shed storm)."""
        out, seen = [], set()
        for ex in self.exemplars(kind):
            key = (ex["scope"], ex["rid"])
            if key in seen:          # ITL exemplars repeat request ids
                continue
            tl = self.resolve(*key)
            if tl is not None:
                out.append(tl)
                seen.add(key)
            if len(out) >= k:
                return out
        if not out:
            ranked = sorted(
                self.timelines(),
                key=lambda t: -_reqtrace().segments(t)["total"])
            out = [self.resolve(t["scope"], t["rid"]) or t
                   for t in ranked[:k]]
        return out[:k]


# ---------------------------------------------------------------------------
# Terminal waterfall
# ---------------------------------------------------------------------------
def _fmt_meta(meta: Optional[dict]) -> str:
    if not meta:
        return ""
    parts = []
    for k, v in meta.items():
        if isinstance(v, float):
            v = round(v, 6)
        if isinstance(v, str) and len(v) > 48:
            v = v[:45] + "..."
        parts.append(f"{k}={v}")
    return "  " + " ".join(parts)


def waterfall(timeline: dict) -> str:
    """One request's timeline as indented text: relative time, delta
    from the previous event, event name + metadata, then the segment
    decomposition line."""
    rt = _reqtrace()
    evs = timeline.get("events", ())
    lines = []
    seg = rt.segments(timeline)
    outcome = next((
        (e.get("meta") or {}).get("outcome")
        for e in reversed(evs) if e["event"] == "terminal"), "<live>")
    head = (f"request {timeline.get('scope')}/rid={timeline.get('rid')}"
            f"  outcome={outcome}  total={seg['total'] * 1e3:.2f}ms")
    if timeline.get("stitched"):
        head += "  (stitched across replicas)"
    lines.append(head)
    t0 = evs[0]["t"] if evs else 0.0
    prev = t0
    for e in evs:
        rel = (e["t"] - t0) * 1e3
        delta = (e["t"] - prev) * 1e3
        prev = e["t"]
        scope = f" [{e['scope']}]" if "scope" in e else ""
        lines.append(f"  {rel:10.3f}ms  (+{delta:8.3f}ms)  "
                     f"{e['event']:<16}{scope}{_fmt_meta(e.get('meta'))}")
    parts = []
    for b in rt.SEGMENT_BUCKETS:
        if seg[b] > 0:
            share = seg[b] / seg["total"] * 100 if seg["total"] else 0.0
            parts.append(f"{b} {seg[b] * 1e3:.2f}ms ({share:.0f}%)")
    lines.append("  segments: " + (" | ".join(parts) or "<empty>")
                 + ("" if seg["complete"] else "  [INCOMPLETE]"))
    problems = rt.validate(timeline)
    for p in problems:
        lines.append(f"  WARNING: {p}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Chrome trace
# ---------------------------------------------------------------------------
#: pid lanes in the merged trace
_PID_DEVICE = 0
_PID_REQUESTS = 1


def chrome_trace(timelines: Sequence[dict],
                 spans: Optional[Sequence] = None,
                 merge_events: Optional[Sequence[dict]] = None) -> dict:
    """One chrome trace: request lanes (segment bars + event marks) on
    a ``requests`` pid, optional engine spans (``trace.drain()``-style
    ``(name, cat, t0, t1, tid, args)`` tuples) on a ``device`` pid, and
    optional pre-rendered chrome events merged verbatim (a profiler
    export — same perf_counter*1e6 timebase)."""
    rt = _reqtrace()
    events: List[dict] = [
        {"name": "process_name", "ph": "M", "pid": _PID_REQUESTS,
         "args": {"name": "requests"}},
        {"name": "process_sort_index", "ph": "M", "pid": _PID_REQUESTS,
         "args": {"sort_index": 1}},
    ]
    for lane, tl in enumerate(timelines):
        # lane index, not the raw rid: two scopes may reuse a rid, and
        # a shared tid would merge their lanes in the viewer
        tid = lane
        label = f"{tl.get('scope')}/rid={tl['rid']}"
        events.append({"name": "thread_name", "ph": "M",
                       "pid": _PID_REQUESTS, "tid": tid,
                       "args": {"name": label}})
        intervals, _complete = rt.segment_intervals(tl)
        for state, t0, t1 in intervals:
            events.append({
                "name": state, "cat": "request", "ph": "X",
                "pid": _PID_REQUESTS, "tid": tid,
                "ts": int(t0 * 1e6),
                "dur": max(int((t1 - t0) * 1e6), 1)})
        for e in tl.get("events", ()):
            args = {"scope": e.get("scope", tl.get("scope"))}
            if e.get("meta"):
                args.update(e["meta"])
            events.append({
                "name": e["event"], "cat": "request_event", "ph": "i",
                "s": "t", "pid": _PID_REQUESTS, "tid": tid,
                "ts": int(e["t"] * 1e6), "args": args})
    if spans:
        events.append({"name": "process_name", "ph": "M",
                       "pid": _PID_DEVICE, "args": {"name": "device"}})
        events.append({"name": "process_sort_index", "ph": "M",
                       "pid": _PID_DEVICE, "args": {"sort_index": 0}})
        for name, cat, t0, t1, tid, args in spans:
            events.append({
                "name": name, "cat": cat, "ph": "X",
                "pid": _PID_DEVICE, "tid": int(tid),
                "ts": int(t0 * 1e6),
                "dur": max(int((t1 - t0) * 1e6), 0),
                "args": args or {}})
    if merge_events:
        events.extend(merge_events)
    events.sort(key=lambda e: (e.get("ts", -1), e.get("pid", 0)))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export(path: str, timelines: Sequence[dict],
           spans: Optional[Sequence] = None,
           merge_events: Optional[Sequence[dict]] = None) -> str:
    """Write the merged chrome trace; returns ``path``."""
    with open(path, "w") as f:
        json.dump(chrome_trace(timelines, spans=spans,
                               merge_events=merge_events), f)
    return path


def serving_spans(spans: Sequence) -> List:
    """Filter ``trace.drain()`` output down to the serving timeline:
    per-tick host spans and the prefill/decode device spans."""
    return [s for s in spans
            if s[1] in ("serving", "device")
            and (s[0].startswith("serving") or s[1] == "serving")]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dump", help="reqtrace dump file "
                    "(PADDLE_TPU_REQTRACE path + .r<rank>)")
    ap.add_argument("--scope", help="timeline scope (replica/router "
                    "name); with --rid selects one request")
    ap.add_argument("--rid", type=int, help="request id within --scope")
    ap.add_argument("--worst", type=int, default=0, metavar="K",
                    help="render the K worst-TTFT exemplar timelines")
    ap.add_argument("--kind", default="ttft", choices=("ttft", "itl"),
                    help="exemplar metric for --worst")
    ap.add_argument("--out", help="write a merged chrome trace here")
    ap.add_argument("--merge-trace", metavar="CHROME_JSON",
                    help="profiler chrome trace whose events (device "
                    "spans) are merged into --out on the same clock")
    ap.add_argument("--list", action="store_true",
                    help="list the dump's timelines and exit")
    args = ap.parse_args(argv)

    if not args.dump:
        ap.error("--dump is required (library callers use "
                 "TimelineSource directly)")
    rt = _reqtrace()
    src = TimelineSource(rt.load_dump(args.dump))

    if args.list:
        for tl in src.timelines():
            seg = rt.segments(tl)
            outcome = next((
                (e.get("meta") or {}).get("outcome")
                for e in reversed(tl.get("events", ()))
                if e["event"] == "terminal"), "<live>")
            print(f"{tl['scope']}/rid={tl['rid']}  {outcome}  "
                  f"total={seg['total'] * 1e3:.2f}ms  "
                  f"events={len(tl.get('events', ()))}")
        return 0

    if args.rid is not None:
        if not args.scope:
            ap.error("--rid needs --scope")
        tl = src.resolve(args.scope, args.rid)
        if tl is None:
            print(f"no timeline for {args.scope}/rid={args.rid} "
                  f"(evicted, or recorded under another scope)")
            return 1
        picked = [tl]
    else:
        picked = src.worst(args.worst or 3, kind=args.kind)
        if not picked:
            print("dump holds no timelines")
            return 1

    for tl in picked:
        print(waterfall(tl))
        print()

    if args.out:
        merge = None
        if args.merge_trace:
            with open(args.merge_trace) as f:
                merge = json.load(f).get("traceEvents", [])
        export(args.out, picked, merge_events=merge)
        print(f"chrome trace written: {args.out} "
              f"({len(picked)} request lane(s)"
              + (f" + {len(merge)} merged device events" if merge
                 else "") + ")")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
