"""Device timing, program analyses and step-time attribution (counterpart
of ``paddle_tpu/observability/perf/device.py``).

* ``measure``/``timed_section``: wall-clock timing that waits for the
  card. PyTorch queues CUDA work, so a host clock read without a
  synchronize measures the enqueue, not the execution: where the JAX
  package calls ``block_until_ready`` on the outputs, the port
  synchronizes the CUDA devices their tensors lie on (CPU tensors are
  ready when they are returned: there is nothing to wait for).
  ``timed_section`` also emits a ``device``-category span over the wait,
  which the attribution counts as compute.
* ``record_compiled``: the cost and memory analysis of each program
  ``to_static`` records and each SOT segment plan (``FLAGS_perf_capture``),
  keyed by site and label. The port compiles no program: a "compiled
  program" is one recording or one segment plan, and its analysis comes
  from running it once under ``costmodel.counted_cost`` (FlopCounterMode
  and the aten ops' bytes).
* ``attribute``/``step_attribution``: each step of a span timeline split
  into compute / collective / host / idle, by priority on one host
  timeline (collective > device > host), idle the uncovered rest, so the
  four parts sum to the step exactly.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ...core import flags
from .. import metrics as _metrics
from .. import trace as _trace

__all__ = ["capture_enabled", "record_compiled", "compiled_programs",
           "clear_compiled", "analyze", "analyze_call", "measure",
           "timed_section", "attribute", "step_attribution",
           "memory_breakdown", "STEP_CAT", "DEVICE_CAT"]

# hot mirror (the metrics.enabled() contract)
_capture = {"on": bool(flags.get_flag("perf_capture"))}
flags.on_change("perf_capture",
                lambda v: _capture.__setitem__("on", bool(v)))


def capture_enabled() -> bool:
    return _capture["on"]


#: span categories the attribution keys on
DEVICE_CAT = "device"
STEP_CAT = "step"
#: host-side span categories (everything instrumented that is neither a
#: wait for the card nor a collective); "io" is the prefetch lane
_HOST_CATS = ("dispatch", "compile", "user", "framework", "serving",
              "autotune", "io")

_m_perf_captures = _metrics.counter(
    "paddle_tpu_perf_captures_total",
    "Compiled-program cost/memory analyses captured, by site.",
    labelnames=("site",))

# --------------------------------------------------------------------------
# Program capture
# --------------------------------------------------------------------------
_MAX_PROGRAMS = 512
_programs: Dict[tuple, dict] = {}
_prog_lock = threading.Lock()


def record_compiled(site: str, label: str, analysis) -> Optional[dict]:
    """Keep the cost and memory analysis of one program (the dict that
    ``analyze_call`` returns), keyed by (site, label); a repeated key
    bumps ``n_captures`` and keeps the latest analysis. Never raises."""
    try:
        rec = {"site": site, "label": str(label), "n_captures": 1,
               "flops": 0.0, "bytes_accessed": 0.0, "transcendentals": 0.0,
               "argument_bytes": 0, "output_bytes": 0, "temp_bytes": 0,
               "alias_bytes": 0, "generated_code_bytes": 0,
               "peak_bytes": 0}
        if analysis:
            for k in ("flops", "bytes_accessed", "transcendentals"):
                rec[k] = float(analysis.get(k, 0.0) or 0.0)
        mb = memory_breakdown(analysis)
        if mb is not None:
            rec.update(mb)
        key = (site, str(label))
        with _prog_lock:
            prev = _programs.get(key)
            if prev is not None:
                rec["n_captures"] = prev["n_captures"] + 1
            elif len(_programs) >= _MAX_PROGRAMS:
                _programs.pop(next(iter(_programs)))
            _programs[key] = rec
        _m_perf_captures.inc(site=site)
        return rec
    except Exception:
        return None


def memory_breakdown(analysis) -> Optional[dict]:
    """The memory fields of one program's analysis, where the peak formula
    lives: ``peak = argument + output + temp - alias`` (the port donates
    nothing, so alias is 0, and no code is generated). None when the
    analysis has no memory fields."""
    if not analysis or "argument_bytes" not in analysis:
        return None
    out = {"argument_bytes": int(analysis.get("argument_bytes", 0)),
           "output_bytes": int(analysis.get("output_bytes", 0)),
           "temp_bytes": int(analysis.get("temp_bytes", 0)),
           "alias_bytes": 0, "generated_code_bytes": 0}
    out["peak_bytes"] = max(0, out["argument_bytes"] + out["output_bytes"]
                            + out["temp_bytes"] - out["alias_bytes"])
    return out


def compiled_programs(site: Optional[str] = None) -> List[dict]:
    """The kept analyses (insertion order), optionally of one site
    ("to_static", "sot", "analyze")."""
    with _prog_lock:
        out = [dict(r) for r in _programs.values()]
    if site is not None:
        out = [r for r in out if r["site"] == site]
    return out


def clear_compiled():
    with _prog_lock:
        _programs.clear()


def _tensors(x) -> List[torch.Tensor]:
    """The torch payloads in ``x``: tensors, Paddle Tensors, and nested
    lists, tuples and dicts of them."""
    out, stack = [], [x]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(getattr(v, "_data", None), torch.Tensor):
            out.append(v._data)
        elif isinstance(v, dict):
            stack.extend(v.values())
        elif isinstance(v, (list, tuple)):
            stack.extend(v)
    return out


def analyze_call(fn: Callable, *args):
    """Run ``fn(*args)`` once and analyze it: ``(output, analysis)`` with
    the FLOPs and bytes of ``costmodel.counted_cost`` and the memory
    fields ``record_compiled`` keeps. ``temp_bytes`` is the peak of what
    the call allocated over what it found allocated: the CUDA
    allocator's peak around the call where CUDA is present (the
    allocator's peak statistic is reset for it), else the peak of the
    storages the call made that were alive at once, from their shapes."""
    from .costmodel import counted_cost

    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    if cuda:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    out, cost = counted_cost(fn, *args)
    outs = _tensors(out)
    seen, out_bytes = set(), 0
    for t in outs:
        key = (t.device.type, t.device.index, t.untyped_storage().data_ptr())
        if key not in seen:
            seen.add(key)
            out_bytes += t.untyped_storage().nbytes()
    if cuda:
        torch.cuda.synchronize()
        made = torch.cuda.max_memory_allocated() - base
    else:
        made = cost["temp_peak_bytes"]
    analysis = dict(cost, output_bytes=out_bytes,
                    temp_bytes=max(0, made - out_bytes))
    return out, analysis


def analyze(fn: Callable, *args) -> Optional[dict]:
    """Run and analyze ``fn(*args)`` and keep it under site "analyze": the
    explicit cross-check entry (the cost model against FlopCounterMode on
    the same call)."""
    _, analysis = analyze_call(fn, *args)
    label = getattr(fn, "__name__", repr(fn))
    return record_compiled("analyze", label, analysis)


# --------------------------------------------------------------------------
# Synchronized measurement
# --------------------------------------------------------------------------
def _block(x):
    """Wait until every CUDA tensor in ``x`` is computed (a synchronize of
    each CUDA device they lie on); CPU tensors are ready already."""
    devices = {t.device for t in _tensors(x) if t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)
    return x


def measure(fn: Callable, *args, warmup: int = 1, iters: int = 3) -> float:
    """Seconds a call of ``fn(*args)``: the queued work is drained before
    the clock starts, and the outputs are computed before it stops."""
    out = None
    for _ in range(max(warmup, 0)):
        out = fn(*args)
    _block(out)
    t0 = time.perf_counter()
    for _ in range(max(iters, 1)):
        out = fn(*args)
    _block(out)
    return (time.perf_counter() - t0) / max(iters, 1)


class timed_section:
    """Scoped timing that waits for the card::

        with perf.device.timed_section("train_step") as ts:
            out = step(batch)
            ts.track(out)
        # ts.seconds: enter -> the tracked outputs computed

    Emits a ``device``-category span over the wait (the card's execution
    window, which the attribution counts as compute) and, with
    ``step=True``, a ``step``-category span over the whole section.
    """

    def __init__(self, name: str, step: bool = True):
        self.name = name
        self._step = step
        self._tracked: List = []
        self.seconds = 0.0
        self.device_seconds = 0.0

    def track(self, out):
        self._tracked.append(out)
        return out

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            tb0 = time.perf_counter()
            _block(self._tracked)
            t1 = time.perf_counter()
            self.seconds = t1 - self._t0
            self.device_seconds = t1 - tb0
            if _trace._active["on"]:
                _trace.add_complete(f"{self.name}.device", DEVICE_CAT,
                                    tb0, t1)
                if self._step:
                    _trace.add_complete(self.name, STEP_CAT, self._t0, t1)
        return False


# --------------------------------------------------------------------------
# Step-time attribution
# --------------------------------------------------------------------------
def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    if not intervals:
        return []
    intervals = sorted(intervals)
    out = [list(intervals[0])]
    for a, b in intervals[1:]:
        if a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _covered(intervals, lo, hi) -> float:
    s = 0.0
    for a, b in intervals:
        s += max(0.0, min(b, hi) - max(a, lo))
    return s


def _subtract_cover(base: List[Tuple[float, float]],
                    cover: List[Tuple[float, float]]):
    """Portions of ``base`` not covered by ``cover`` (both merged)."""
    out = []
    for a, b in base:
        cur = a
        for c, d in cover:
            if d <= cur or c >= b:
                continue
            if c > cur:
                out.append((cur, min(c, b)))
            cur = max(cur, d)
            if cur >= b:
                break
        if cur < b:
            out.append((cur, b))
    return out


def attribute(spans: Sequence[tuple],
              steps: Optional[Sequence[Tuple[float, float]]] = None) -> dict:
    """Split the step windows of a span timeline into compute /
    collective / host / idle seconds.

    ``spans`` are trace-buffer tuples ``(name, cat, t0, t1, tid, args)``;
    ``steps`` are (t0, t1) windows, by default the ``step``-category
    spans. Overlaps resolve by priority collective > compute (device) >
    host; idle is the uncovered rest, so a step's four parts sum to
    t1 − t0 exactly. Returns ``{"steps": [per-step dicts], "total": the
    aggregate}``.
    """
    coll, dev, host = [], [], []
    step_windows = list(steps) if steps is not None else []
    for name, cat, t0, t1, _tid, _args in spans:
        if t1 <= t0:
            continue
        if cat == STEP_CAT and steps is None:
            step_windows.append((t0, t1))
        elif cat == "collective":
            coll.append((t0, t1))
        elif cat == DEVICE_CAT:
            dev.append((t0, t1))
        elif cat in _HOST_CATS:
            host.append((t0, t1))
    coll, dev, host = _merge(coll), _merge(dev), _merge(host)
    # a wait that contains a collective counts as collective for the
    # contained part; host spans yield to both
    dev_x = _subtract_cover(dev, coll)
    host_x = _subtract_cover(_subtract_cover(host, coll), dev)
    per_step = []
    for t0, t1 in sorted(step_windows):
        total = t1 - t0
        c = _covered(coll, t0, t1)
        d = _covered(dev_x, t0, t1)
        h = _covered(host_x, t0, t1)
        idle = max(0.0, total - c - d - h)
        per_step.append({
            "step_s": total, "compute_s": d, "collective_s": c,
            "host_s": h, "idle_s": idle,
            "compute_frac": d / total if total else 0.0,
            "collective_frac": c / total if total else 0.0,
            "host_frac": h / total if total else 0.0,
            "idle_frac": idle / total if total else 0.0,
        })
    total = {k: sum(s[k] for s in per_step)
             for k in ("step_s", "compute_s", "collective_s", "host_s",
                       "idle_s")}
    st = total["step_s"]
    for k in ("compute", "collective", "host", "idle"):
        total[f"{k}_frac"] = (total[f"{k}_s"] / st) if st else 0.0
    total["n_steps"] = len(per_step)
    return {"steps": per_step, "total": total}


def step_attribution(step_fn: Callable, iters: int = 2, warmup: int = 1,
                     name: str = "step") -> dict:
    """Run ``step_fn()`` ``iters`` times under a trace window, each in a
    ``timed_section``, and return ``attribute()``'s result. The helper
    owns the span buffer while it runs: inside an active profiler
    recording it reads the buffer without draining it and attributes
    only its own window's spans."""
    was_active = _trace.active()
    for _ in range(max(warmup, 0)):
        _block(step_fn())
    if not was_active:
        _trace.clear()
        _trace.activate()
    t_begin = time.perf_counter()
    try:
        for _ in range(max(iters, 1)):
            with timed_section(name) as ts:
                ts.track(step_fn())
    finally:
        if not was_active:
            _trace.deactivate()
    spans = (_trace.tail(_trace.MAX_EVENTS) if was_active
             else _trace.drain())
    spans = [s for s in spans if s[2] >= t_begin]
    out = attribute(spans)
    out["total"]["name"] = name
    return out
