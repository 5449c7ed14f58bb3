"""Anomaly sentinel — online regression detection over training runs
(counterpart of ``paddle_tpu/observability/sentinel.py``, the JAX
package's code).

No human watches a pod: regressions must be caught online, not in
post-hoc bench runs.  The sentinel holds rolling robust statistics
(median/MAD, EWMA) over step time, loss, and the goodput ledger's
per-bucket shares, and fires typed incidents:

- ``step_time_spike``       — one step far outside the MAD envelope
- ``step_time_drift``       — sustained slowdown (two-window change-point)
- ``compile_storm``         — retrace burst inside one window
- ``data_stall_regression`` — data-stall bucket share jumped vs the
  previous window
- ``straggler_flip``        — the fleet's slowest rank changed while a
  straggler is flagged
- ``nonfinite_loss``        — NaN/Inf loss observed

Each incident carries a "what changed" diff of the pre/post-window
goodput-bucket shares naming the dominant bucket, is rate-limited to one
stderr warning per incident (with a per-kind cooldown window so storms
don't spam), counted in ``paddle_tpu_sentinel_incidents_total{kind=}``,
ring-buffered, and persisted through the watchdog hang path, fleet
snapshots and the ``PADDLE_TPU_GOODPUT`` exit dump.

``FLAGS_sentinel`` gates everything at dict-lookup cost; the sentinel
reads no clocks of its own — its step-time feed is the ledger's
``step_end`` return value.
"""
from __future__ import annotations

import math
import sys
import threading
from collections import deque
from typing import Deque, Dict, List, Optional

from ..core import flags
from . import metrics as _metrics

__all__ = ["AnomalySentinel", "get", "reset", "INCIDENT_KINDS",
           "on_incident", "remove_incident_observer"]

flags.define_flag(
    "sentinel", True,
    "Online anomaly detection over step time / loss / goodput buckets. "
    "Costs one dict lookup per step when off.")

_hot = {"on": bool(flags.get_flag("sentinel"))}
flags.on_change("sentinel", lambda v: _hot.__setitem__("on", bool(v)))

INCIDENT_KINDS = ("step_time_spike", "step_time_drift", "compile_storm",
                  "data_stall_regression", "straggler_flip",
                  "nonfinite_loss")

M_INCIDENTS = _metrics.counter(
    "paddle_tpu_sentinel_incidents_total",
    "Anomaly incidents fired, by kind.", labelnames=("kind",))

#: incident observers (fault.supervisor's remediation engine registers
#: here).  Called from ``_fire`` UNDER the sentinel's lock — an observer
#: must only enqueue, never act inline.
_OBSERVERS: List = []


def on_incident(fn):
    """Register ``fn(incident_dict)`` to be called on every fired
    incident (after the cooldown filter).  Runs under the sentinel's
    lock: observers must be non-blocking (enqueue and return)."""
    if fn not in _OBSERVERS:
        _OBSERVERS.append(fn)


def remove_incident_observer(fn):
    try:
        _OBSERVERS.remove(fn)
    except ValueError:
        pass

#: MAD multiplier for the spike envelope (1.4826 scales MAD to sigma
#: under normality; 8 sigma keeps benign jitter quiet)
_SPIKE_K = 8.0
#: spikes also need at least +50% over the median (absolute floor so a
#: microsecond-tight MAD doesn't flag noise)
_SPIKE_FLOOR = 0.5
#: two-window drift: current window mean must exceed previous by 25%
_DRIFT_RATIO = 1.25
#: retraces within one window that constitute a compile storm
_STORM_RETRACES = 3
#: absolute increase in data_stall bucket share that flags a regression
_STALL_SHARE_DELTA = 0.10


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    m = n // 2
    return s[m] if n % 2 else 0.5 * (s[m - 1] + s[m])


class AnomalySentinel:
    """Rolling-statistics watchdog for one rank's training loop."""

    def __init__(self, window: int = 32, ring: int = 256,
                 ewma_alpha: float = 0.1, stream=None):
        self.window = max(4, int(window))
        self._stream = stream           # default: sys.stderr at fire time
        self._lock = threading.Lock()
        self._steps: Deque[float] = deque(maxlen=self.window)
        self._ewma: Optional[float] = None
        self._alpha = ewma_alpha
        self._n = 0                     # observed steps
        self._win_sum = 0.0             # current window accumulator
        self._win_n = 0
        self._prev_win_mean: Optional[float] = None
        self._win_retraces = 0
        self._prev_shares: Optional[Dict[str, float]] = None
        self._prev_cum: Optional[Dict[str, float]] = None
        self._slowest_rank: Optional[int] = None
        self._last_fire: Dict[str, int] = {}
        self._incidents: Deque[dict] = deque(maxlen=ring)
        self._counts: Dict[str, int] = {}

    # -- feeds -------------------------------------------------------------
    def observe_step(self, step_s: Optional[float],
                     loss: Optional[float] = None,
                     step: Optional[int] = None):
        """Per-step feed.  ``step_s`` is the ledger's step wall (None →
        no-op, so a cold ledger feeds nothing); ``loss`` a host float
        when the loop already materialised one (never forces a sync)."""
        if not _hot["on"] or step_s is None:
            return
        with self._lock:
            self._n += 1
            at = step if step is not None else self._n
            if loss is not None and not math.isfinite(loss):
                self._fire("nonfinite_loss", at,
                           f"loss={loss!r} at step {at}")
            hist = list(self._steps)
            if len(hist) >= self.window // 2:
                med = _median(hist)
                mad = _median([abs(x - med) for x in hist])
                envelope = med + max(_SPIKE_K * 1.4826 * mad,
                                     _SPIKE_FLOOR * med)
                if step_s > envelope > 0:
                    self._fire(
                        "step_time_spike", at,
                        f"step took {step_s * 1e3:.1f}ms vs median "
                        f"{med * 1e3:.1f}ms (envelope "
                        f"{envelope * 1e3:.1f}ms)")
            self._steps.append(step_s)
            self._ewma = (step_s if self._ewma is None else
                          self._alpha * step_s +
                          (1 - self._alpha) * self._ewma)
            self._win_sum += step_s
            self._win_n += 1
            if self._win_n >= self.window:
                self._roll_window(at)

    def note_compile(self, kind: str = "initial", seconds: float = 0.0):
        """Compile-seam feed (jit/SOT): retraces count toward the
        compile-storm detector; initial compiles are expected."""
        if not _hot["on"]:
            return
        if kind == "retrace":
            with self._lock:
                self._win_retraces += 1

    def note_straggler(self, slowest_rank: Optional[int],
                       is_straggler: bool, skew: float = 0.0):
        """FleetBeacon window feed: a *change* of slowest rank while a
        straggler is flagged is topology news, not noise."""
        if not _hot["on"] or slowest_rank is None:
            return
        with self._lock:
            prev = self._slowest_rank
            if is_straggler:
                if prev is not None and prev != slowest_rank:
                    self._fire(
                        "straggler_flip", self._n,
                        f"slowest rank changed {prev} -> {slowest_rank} "
                        f"(skew {skew:.2f}x)")
                self._slowest_rank = slowest_rank

    # -- internals ---------------------------------------------------------
    def _roll_window(self, at: int):
        cur_mean = self._win_sum / max(1, self._win_n)
        prev_mean = self._prev_win_mean
        # this window's shares are computed ONCE and handed to every
        # fire below, so roll-boundary incidents carry the closing
        # window's diff (not an empty zero-wall delta)
        shares = self._bucket_shares()
        if (prev_mean is not None and prev_mean > 0
                and cur_mean > _DRIFT_RATIO * prev_mean):
            self._fire(
                "step_time_drift", at,
                f"window mean step time {cur_mean * 1e3:.1f}ms vs "
                f"previous window {prev_mean * 1e3:.1f}ms "
                f"({cur_mean / prev_mean:.2f}x)", post=shares)
        if self._win_retraces >= _STORM_RETRACES:
            self._fire(
                "compile_storm", at,
                f"{self._win_retraces} retraces within one "
                f"{self.window}-step window", post=shares)
        if shares is not None and self._prev_shares is not None:
            delta = (shares.get("data_stall", 0.0)
                     - self._prev_shares.get("data_stall", 0.0))
            if delta > _STALL_SHARE_DELTA:
                self._fire(
                    "data_stall_regression", at,
                    f"data_stall share +{delta:.0%} vs previous window "
                    f"(now {shares['data_stall']:.0%})", post=shares)
        if shares is not None:
            self._prev_shares = shares
        self._prev_win_mean = cur_mean
        self._win_sum = 0.0
        self._win_n = 0
        self._win_retraces = 0

    def _bucket_shares(self, commit: bool = True) -> Optional[Dict[str, float]]:
        """This window's goodput-bucket shares (delta of the ledger's
        cumulative account vs the previous window boundary).  With
        ``commit=False`` it peeks without advancing the boundary — used
        by mid-window fires so they cannot skew the next roll's delta."""
        from . import goodput as _goodput
        led = _goodput.ledger()
        if not led.running():
            return None
        snap = led.snapshot()
        cum = dict(snap["buckets"])
        cum["_wall"] = snap["wall_s"]
        prev = self._prev_cum or {}
        if commit:
            self._prev_cum = cum
        wall = cum["_wall"] - prev.get("_wall", 0.0)
        if wall <= 0:
            return None
        return {b: max(0.0, cum.get(b, 0.0) - prev.get(b, 0.0)) / wall
                for b in _goodput.BUCKETS}

    def _fire(self, kind: str, at: int, detail: str,
              post: Optional[Dict[str, float]] = None):
        # per-kind cooldown of one window: storms produce ONE incident
        # (and one stderr line), not one per step
        last = self._last_fire.get(kind)
        if last is not None and at - last < self.window:
            return
        self._last_fire[kind] = at
        pre = dict(self._prev_shares or {})
        if post is None:
            post = self._bucket_shares(commit=False) or {}
        dominant = None
        if post:
            dominant = max(post, key=lambda b: post[b] - pre.get(b, 0.0))
        incident = {"kind": kind, "step": at, "detail": detail,
                    "diff": {"pre": pre, "post": post,
                             "dominant_bucket": dominant},
                    "ewma_step_s": self._ewma}
        self._incidents.append(incident)
        self._counts[kind] = self._counts.get(kind, 0) + 1
        M_INCIDENTS.inc(kind=kind)
        stream = self._stream or sys.stderr
        try:
            dom = f", dominant bucket: {dominant}" if dominant else ""
            print(f"[paddle_tpu.sentinel] {kind} @ step {at}: "
                  f"{detail}{dom}", file=stream)
        except Exception:
            pass
        for fn in list(_OBSERVERS):
            try:
                fn(dict(incident))
            except Exception:
                pass   # an observer bug must never mask the incident

    # -- reporting ---------------------------------------------------------
    def incidents(self, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            out = list(self._incidents)
        return out[-n:] if n else out

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def snapshot(self) -> dict:
        with self._lock:
            return {"observed_steps": self._n,
                    "ewma_step_s": self._ewma,
                    "counts": dict(self._counts),
                    "incidents": list(self._incidents)}


_sentinel = {"s": AnomalySentinel()}


def get() -> AnomalySentinel:
    return _sentinel["s"]


def reset(window: int = 32, ring: int = 256, stream=None) -> AnomalySentinel:
    """Fresh sentinel (tests / explicit new-job boundaries)."""
    _sentinel["s"] = AnomalySentinel(window=window, ring=ring, stream=stream)
    return _sentinel["s"]
