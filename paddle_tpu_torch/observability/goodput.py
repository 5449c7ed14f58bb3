"""Training goodput ledger — job-lifetime badput accounting (counterpart
of ``paddle_tpu/observability/goodput.py``, the JAX package's code; the
rank of the exit dump's path comes from the launcher's environment,
``reqtrace.rank_world``, until ``observability/flight`` is ported).

Partitions every second of a run's wall clock into named buckets
(MegaScale, arXiv:2402.15627, reports per-cause badput decomposition as
the key operability lens at 10k-accelerator scale; Google's ML-goodput
methodology for TPU pods is the same discipline):

- ``productive``  — step wall spent in device compute + collectives
- ``compile``     — trace + XLA compile (jit/SOT seams; a pcc hit bills
  near-zero because only the cache-load wall is inside the seam)
- ``checkpoint``  — CheckpointManager save/restore + async-save waits
- ``data_stall``  — DevicePrefetcher stall seconds (input starvation)
- ``host``        — host-side Python/dispatch/idle time between and
  inside steps (the residual bucket, so the sum is exact)
- ``straggler``   — skew badput: wall this rank lost waiting relative to
  the fleet-median step time (FleetBeacon window stats)
- ``rewind``      — steps recomputed after ``fault.auto_resume`` since
  the last durable checkpoint (the badput class only the fault layer
  can see)

Buckets are exhaustive and sum to wall time exactly: billed badput is
swept with the same interval-merge discipline as ``perf.attribute``
(higher-priority buckets own overlaps), step wall is net of badput
billed inside the step window, and ``host`` is constructed as the
residual.  Exported as ``paddle_tpu_goodput_seconds_total{bucket=}``
plus a live ``paddle_tpu_goodput_fraction`` gauge, and persisted as a
rank-suffixed ``PADDLE_TPU_GOODPUT`` exit dump (the ``<base>.r<rank>``
convention of the reqtrace records). The cross-rank gather through
``fleet.snapshot()`` waits for the port of ``observability/fleet``.

Disabled (``FLAGS_goodput=0``) or outside a run, every seam costs one
dict lookup and reads **zero** clocks; tests assert it with a counting
clock.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..core import flags
from . import metrics as _metrics

__all__ = ["BUCKETS", "GoodputLedger", "ledger", "reset_ledger", "bill",
           "bill_interval", "on_compile", "record_path", "dump",
           "load_dump", "merge_dumps", "RECORD_ENV"]

flags.define_flag(
    "goodput", True,
    "Account run wall-clock into goodput/badput buckets (compile, "
    "checkpoint, data stall, straggler, rewind...). Costs one dict "
    "lookup per seam when off or outside a run.")

#: stable bucket vocabulary (doc'd in README; dashboards key on these)
BUCKETS: Tuple[str, ...] = ("productive", "compile", "checkpoint",
                            "data_stall", "host", "straggler", "rewind")

#: billed-interval buckets in overlap-priority order (highest first):
#: a second inside both a checkpoint save and a compile is a checkpoint
#: second — same resolution discipline as ``perf.attribute``
BILLED_PRIORITY: Tuple[str, ...] = ("checkpoint", "compile", "data_stall")

RECORD_ENV = "PADDLE_TPU_GOODPUT"

_MAX_BILLED = 4096          # interval list cap; oldest half folds to carry
_EXPORT_EVERY = 16          # steps between metric-counter refreshes

# Hot mirror: seams check only this dict. It is the AND of FLAGS_goodput
# and "a run is active", so the off/idle path reads zero clocks.
_hot = {"on": False}
_flag = {"on": bool(flags.get_flag("goodput"))}


def _on_flag_change(v):
    _flag["on"] = bool(v)
    _hot["on"] = _flag["on"] and _ledger["l"].running()


flags.on_change("goodput", _on_flag_change)

M_SECONDS = _metrics.counter(
    "paddle_tpu_goodput_seconds_total",
    "Run wall-clock seconds attributed per goodput/badput bucket.",
    labelnames=("bucket",))
M_FRACTION = _metrics.gauge(
    "paddle_tpu_goodput_fraction",
    "Live productive fraction of run wall clock (this rank).")


def _merge(ivs: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merge overlapping [a, b) intervals (perf.attribute discipline)."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(i for i in ivs if i[1] > i[0]):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _subtract(ivs: List[Tuple[float, float]],
              cover: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Clip merged ``ivs`` by removing the (merged) ``cover`` set."""
    out: List[Tuple[float, float]] = []
    for a, b in ivs:
        cur = a
        for ca, cb in cover:
            if cb <= cur or ca >= b:
                continue
            if ca > cur:
                out.append((cur, min(ca, b)))
            cur = max(cur, cb)
            if cur >= b:
                break
        if cur < b:
            out.append((cur, b))
    return out


class GoodputLedger:
    """One rank's wall-clock account.  All mutation APIs are no-ops
    (zero clock reads) unless the ledger is running and FLAGS_goodput
    is on; ``clock`` is injectable for deterministic tests."""

    def __init__(self, clock=None):
        self._clock = clock or time.perf_counter
        self._lock = threading.Lock()
        self._t0: Optional[float] = None
        self._t_end: Optional[float] = None
        self._billed: List[Tuple[str, float, float]] = []
        self._carry: Dict[str, float] = {}
        self._steps = 0
        self._step_net_s = 0.0
        self._rewind_steps = 0
        self._rewind_s = 0.0
        self._rewind_left = 0
        self._skew_s = 0.0
        self._busy_frac = 1.0          # from step_attribution probes
        self._step_t0: Optional[float] = None
        self._mark = 0
        self._exported: Dict[str, float] = {}
        self.last_step = -1            # last global step seen (for rewind)
        self.resumes: List[dict] = []

    # -- lifecycle ---------------------------------------------------------
    def running(self) -> bool:
        return self._t0 is not None and self._t_end is None

    def run_begin(self):
        """Start (or continue) the job-lifetime account.  Idempotent:
        a second ``fit`` keeps accumulating on the same clock origin, so
        inter-fit idle lands in ``host`` — which is what a job-level
        goodput number must charge for."""
        if not _flag["on"]:
            return self
        if self._t0 is None:
            self._t0 = self._clock()
        self._t_end = None
        _hot["on"] = True
        return self

    def run_end(self):
        if self._t0 is not None and self._t_end is None:
            self._t_end = self._clock()
        _hot["on"] = False
        self.export_metrics()
        return self

    # -- step accounting ---------------------------------------------------
    def step_begin(self):
        if not _hot["on"]:
            return
        self._step_t0 = self._clock()
        self._mark = len(self._billed)

    def step_end(self, step: Optional[int] = None) -> Optional[float]:
        """Close the step window; returns the step wall (the sentinel's
        feed, so observing costs no extra clock reads)."""
        if not _hot["on"] or self._step_t0 is None:
            return None
        t0, t1 = self._step_t0, self._clock()
        self._step_t0 = None
        wall = max(0.0, t1 - t0)
        with self._lock:
            billed = self._billed[self._mark:]
        overlap = sum(max(0.0, min(b, t1) - max(a, t0))
                      for _, a, b in billed)
        net = max(0.0, wall - overlap)
        if self._rewind_left > 0:
            self._rewind_left -= 1
            self._rewind_steps += 1
            self._rewind_s += net
        else:
            self._steps += 1
            self._step_net_s += net
        self.last_step = step if step is not None else self.last_step + 1
        total = self._steps + self._rewind_steps
        if total % _EXPORT_EVERY == 0 and _metrics.enabled():
            self.export_metrics(now=t1)
        return wall

    # -- badput seams ------------------------------------------------------
    def bill_interval(self, bucket: str, a: float, b: float):
        """Attribute wall interval [a, b) to a billed badput bucket."""
        if not _hot["on"] or b <= a:
            return
        with self._lock:
            self._billed.append((bucket, a, b))
            if len(self._billed) > _MAX_BILLED:
                self._fold_locked()

    def _fold_locked(self):
        """Fold the oldest half of the interval list into per-bucket
        carry seconds (priority-swept first, so folding cannot change
        the totals)."""
        old, self._billed = (self._billed[:_MAX_BILLED // 2],
                             self._billed[_MAX_BILLED // 2:])
        for bucket, secs in self._sweep(old).items():
            self._carry[bucket] = self._carry.get(bucket, 0.0) + secs

    @staticmethod
    def _sweep(items: List[Tuple[str, float, float]]) -> Dict[str, float]:
        per: Dict[str, List[Tuple[float, float]]] = {}
        for bkt, a, b in items:
            per.setdefault(bkt, []).append((a, b))
        covered: List[Tuple[float, float]] = []
        out: Dict[str, float] = {}
        order = [b for b in BILLED_PRIORITY if b in per]
        order += [b for b in per if b not in BILLED_PRIORITY]
        for bkt in order:
            ivs = _merge(per[bkt])
            kept = _subtract(ivs, covered)
            out[bkt] = sum(b - a for a, b in kept)
            covered = _merge(covered + ivs)
        return out

    def bill_since_step_begin(self, bucket: str):
        """Attribute the wall from the open step's start to now (e.g.
        a jit-cache miss detected after the traced call returned: the
        trace+compile wall sits at the head of the step window)."""
        if not _hot["on"] or self._step_t0 is None:
            return
        self.bill_interval(bucket, self._step_t0, self._clock())

    # -- cross-signal feeds ------------------------------------------------
    def note_attribution(self, compute_frac: float, collective_frac: float,
                         host_frac: float, idle_frac: float):
        """Latest ``step_attribution`` probe (FleetBeacon window): the
        busy fraction splits step wall into productive vs host."""
        if not _hot["on"]:
            return
        tot = compute_frac + collective_frac + host_frac + idle_frac
        if tot > 0:
            self._busy_frac = min(
                1.0, max(0.0, (compute_frac + collective_frac) / tot))

    def note_skew(self, steps: int, own_mean_s: float, median_mean_s: float):
        """FleetBeacon window skew: this rank's per-step excess over the
        fleet median, accumulated as straggler badput."""
        if not _hot["on"]:
            return
        self._skew_s += max(0, steps) * max(0.0, own_mean_s - median_mean_s)

    def note_resume(self, restored_step: int,
                    crashed_step: Optional[int] = None):
        """``fault.auto_resume`` restored ``restored_step``; the steps
        from there to where the crashed run had progressed are recomputed
        work — billed ``rewind`` as they re-run.  The prior progress
        comes from this ledger (same-process resume), an explicit
        ``crashed_step``, or the previous process's exit dump."""
        if not _flag["on"]:
            return
        if crashed_step is None and self.last_step >= 0:
            crashed_step = self.last_step
        if crashed_step is None:
            p = record_path()
            if p and os.path.exists(p):
                try:
                    crashed_step = load_dump(p).get("last_step")
                except Exception:
                    crashed_step = None
        rewind = (max(0, int(crashed_step) - int(restored_step))
                  if crashed_step is not None else 0)
        self._rewind_left += rewind
        self.resumes.append({"restored_step": int(restored_step),
                             "crashed_step": crashed_step,
                             "rewind_steps": rewind})

    # -- reporting ---------------------------------------------------------
    def snapshot(self, now: Optional[float] = None) -> dict:
        """Exhaustive bucket account.  ``host`` is the residual, so
        ``sum(buckets) == wall`` exactly (clamped re-normalisation if
        concurrent billing over-attributed)."""
        if self._t0 is None:
            return {"running": False, "wall_s": 0.0,
                    "buckets": {b: 0.0 for b in BUCKETS},
                    "goodput_fraction": 0.0, "steps": 0,
                    "rewind_steps": 0, "resumes": []}
        if now is None:
            now = self._t_end if self._t_end is not None else self._clock()
        wall = max(0.0, now - self._t0)
        with self._lock:
            items = list(self._billed)
            carry = dict(self._carry)
        swept = self._sweep(items)
        buckets = {b: 0.0 for b in BUCKETS}
        for bkt in BILLED_PRIORITY:
            buckets[bkt] = swept.get(bkt, 0.0) + carry.get(bkt, 0.0)
        busy = self._step_net_s * self._busy_frac
        straggler = min(self._skew_s, busy)
        buckets["straggler"] = straggler
        buckets["productive"] = max(0.0, busy - straggler)
        buckets["rewind"] = self._rewind_s
        used = sum(buckets.values())
        buckets["host"] = wall - used
        if buckets["host"] < 0.0:
            # concurrent seams (async-save waits spanning closed steps)
            # can over-bill; re-normalise by shaving buckets in reverse
            # priority so the sum stays exactly wall
            deficit = -buckets["host"]
            buckets["host"] = 0.0
            for bkt in ("productive", "data_stall", "compile",
                        "checkpoint", "straggler", "rewind"):
                take = min(deficit, buckets[bkt])
                buckets[bkt] -= take
                deficit -= take
                if deficit <= 0.0:
                    break
        frac = buckets["productive"] / wall if wall > 0 else 0.0
        return {"running": self.running(), "wall_s": wall,
                "buckets": buckets, "goodput_fraction": frac,
                "steps": self._steps, "rewind_steps": self._rewind_steps,
                "last_step": self.last_step,
                "resumes": list(self.resumes)}

    def export_metrics(self, now: Optional[float] = None):
        """Refresh the Prometheus counters to the current cumulative
        account (clamped deltas keep them monotone)."""
        if not _metrics.enabled() or self._t0 is None:
            return
        snap = self.snapshot(now=now)
        for bkt, secs in snap["buckets"].items():
            delta = secs - self._exported.get(bkt, 0.0)
            if delta > 0:
                M_SECONDS.inc(delta, bucket=bkt)
                self._exported[bkt] = secs


_ledger = {"l": GoodputLedger()}


def ledger() -> GoodputLedger:
    return _ledger["l"]


def reset_ledger(clock=None) -> GoodputLedger:
    """Fresh ledger (tests / explicit new-job boundaries)."""
    _hot["on"] = False
    _ledger["l"] = GoodputLedger(clock)
    return _ledger["l"]


class _Bill:
    """``with bill("checkpoint"):`` seam — zero clock reads unless the
    ledger is hot at entry."""

    __slots__ = ("bucket", "_t0")

    def __init__(self, bucket: str):
        self.bucket = bucket
        self._t0 = None

    def __enter__(self):
        if _hot["on"]:
            self._t0 = _ledger["l"]._clock()
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            led = _ledger["l"]
            led.bill_interval(self.bucket, self._t0, led._clock())
            self._t0 = None
        return False


def bill(bucket: str) -> _Bill:
    return _Bill(bucket)


def bill_interval(bucket: str, a: float, b: float):
    if _hot["on"]:
        _ledger["l"].bill_interval(bucket, a, b)


def on_compile(seconds: float, kind: str = "initial"):
    """Compile-seam feed: bills the compile wall ending *now* and tells
    the sentinel (retrace bursts are its compile-storm signal)."""
    if _hot["on"] and seconds > 0:
        led = _ledger["l"]
        now = led._clock()
        led.bill_interval("compile", now - seconds, now)
    from . import sentinel as _sentinel
    _sentinel.get().note_compile(kind=kind, seconds=seconds)


def _goodput_fraction_live() -> float:
    led = _ledger["l"]
    if led._t0 is None:
        return 0.0
    return led.snapshot()["goodput_fraction"]


M_FRACTION.set_function(_goodput_fraction_live)


# ---------------------------------------------------------------------------
# Persistence (mirrors flight/reqtrace: rank-suffixed exit dump + the
# watchdog hang path)
# ---------------------------------------------------------------------------
def record_path(base: Optional[str] = None,
                rank: Optional[int] = None) -> Optional[str]:
    """Per-rank dump path ``<base>.r<rank>`` (same convention as the
    flight record, so one env var covers a fleet)."""
    from .reqtrace import rank_world
    base = base if base is not None else os.environ.get(RECORD_ENV)
    if not base:
        return None
    r = rank if rank is not None else rank_world()[0]
    return f"{base}.r{r}"


def dump(path: Optional[str] = None, reason: str = "") -> Optional[str]:
    """Persist the ledger snapshot + sentinel incidents.  Never raises —
    this runs from atexit, crash and hang paths."""
    try:
        from . import sentinel as _sentinel
        from .reqtrace import rank_world
        path = path or record_path()
        if not path:
            return None
        led = _ledger["l"]
        if led._t0 is None:
            return None
        rank, world = rank_world()
        payload = {"format": "paddle_tpu.goodput/1",
                   "rank": rank, "world": world, "pid": os.getpid(),
                   "reason": reason, "unix_time": time.time(),
                   "last_step": led.last_step,
                   "goodput": led.snapshot(),
                   "sentinel": _sentinel.get().snapshot()}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return path
    except Exception:
        return None


def load_dump(path: str) -> dict:
    """Load one goodput dump file (format-checked)."""
    with open(path) as f:
        payload = json.load(f)
    if payload.get("format") != "paddle_tpu.goodput/1":
        raise ValueError(f"{path}: not a goodput dump "
                         f"(format={payload.get('format')!r})")
    return payload


def merge_dumps(base: str) -> List[dict]:
    """Load every ``<base>.r<rank>`` dump, sorted by rank."""
    import glob as _glob
    out = []
    for p in sorted(_glob.glob(f"{base}.r*")):
        try:
            out.append(load_dump(p))
        except Exception:
            continue
    return sorted(out, key=lambda d: d.get("rank", 0))


def _install_exit_dump():
    """Registered unconditionally: ``dump()`` re-reads
    the env at exit, so setting PADDLE_TPU_GOODPUT after import still
    produces a record (and an unset one stays a no-op)."""
    import atexit
    atexit.register(lambda: dump(reason="atexit"))


_install_exit_dump()
