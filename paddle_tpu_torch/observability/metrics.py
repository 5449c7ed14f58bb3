"""Metrics registry: labeled counters, gauges, histograms (counterpart of
``paddle_tpu/observability/metrics.py``).

Instruments are created once at import time by the subsystems that emit
them; recording is gated by ``FLAGS_enable_metrics`` (off by default) and
costs one dict lookup, and reads no clock, when the flag is off.

Exports: Prometheus text exposition (``REGISTRY.to_prometheus()``) and a
JSON-able snapshot (``REGISTRY.snapshot()``). Metric names are the JAX
package's (``paddle_tpu_*``): a dashboard keyed on them reads either
package.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..core import flags

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "enabled", "counter", "gauge", "histogram", "DEFAULT_BUCKETS",
           "merge_snapshots", "merge_snapshot_files"]

flags.define_flag(
    "enable_metrics", False,
    "Collect framework telemetry (counters/gauges/histograms). Off by "
    "default: every instrumentation site is compiled out to one dict "
    "lookup.")

# Hot mirror: instrumentation sites call enabled() per event, so the check
# must stay at dict-lookup cost.
_enabled = {"on": bool(flags.get_flag("enable_metrics"))}
flags.on_change("enable_metrics",
                lambda v: _enabled.__setitem__("on", bool(v)))


def enabled() -> bool:
    return _enabled["on"]


#: histogram bucket upper bounds in seconds, spanning µs-level host dispatch
#: through multi-second compiles (+Inf is implicit as the last bucket)
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-6, 2.5e-6, 5e-6, 1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class _Metric:
    """Base: one named instrument holding per-label-tuple children."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _label_values(self, labels: Dict[str, Any]) -> tuple:
        if tuple(labels) != self.labelnames:
            # allow any order, require exactly the declared names
            if set(labels) != set(self.labelnames):
                raise ValueError(
                    f"metric {self.name!r} takes labels {self.labelnames}, "
                    f"got {tuple(labels)}")
        return tuple(str(labels[k]) for k in self.labelnames)

    def clear(self):
        raise NotImplementedError


class Counter(_Metric):
    """Monotonically increasing count, optionally labeled."""

    kind = "counter"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._vals: Dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels):
        if not _enabled["on"]:
            return
        key = self._label_values(labels)
        with self._lock:
            self._vals[key] = self._vals.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self._vals.get(self._label_values(labels), 0.0)

    def total(self) -> float:
        return sum(self._vals.values())

    def clear(self):
        with self._lock:
            self._vals.clear()

    def _series(self):
        return [(k, v) for k, v in sorted(self._vals.items())]


class Gauge(_Metric):
    """Point-in-time value; can also wrap a callback evaluated at
    snapshot time."""

    kind = "gauge"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._vals: Dict[tuple, float] = {}
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float, **labels):
        if not _enabled["on"]:
            return
        with self._lock:
            self._vals[self._label_values(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels):
        if not _enabled["on"]:
            return
        key = self._label_values(labels)
        with self._lock:
            self._vals[key] = self._vals.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels):
        self.inc(-amount, **labels)

    def set_function(self, fn: Callable[[], float]):
        """Callback gauge: evaluated lazily at snapshot/export time (never
        on the hot path). Only valid for unlabeled gauges."""
        if self.labelnames:
            raise ValueError("callback gauges cannot be labeled")
        self._fn = fn
        return self

    def value(self, **labels) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                return 0.0
        return self._vals.get(self._label_values(labels), 0.0)

    def clear(self):
        with self._lock:
            self._vals.clear()

    def _series(self):
        if self._fn is not None:
            return [((), self.value())]
        return [(k, v) for k, v in sorted(self._vals.items())]


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus layout: per-bucket counts,
    running sum, total count)."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), buckets=None):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        # label tuple -> [bucket_counts(list), sum, count]
        self._vals: Dict[tuple, list] = {}

    def observe(self, value: float, **labels):
        if not _enabled["on"]:
            return
        key = self._label_values(labels)
        with self._lock:
            st = self._vals.get(key)
            if st is None:
                st = self._vals[key] = [[0] * (len(self.buckets) + 1),
                                        0.0, 0]
            counts = st[0]
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1            # +Inf bucket
            st[1] += value
            st[2] += 1

    def count(self, **labels) -> int:
        st = self._vals.get(self._label_values(labels))
        return st[2] if st else 0

    def sum(self, **labels) -> float:
        st = self._vals.get(self._label_values(labels))
        return st[1] if st else 0.0

    def total_count(self) -> int:
        return sum(st[2] for st in self._vals.values())

    def clear(self):
        with self._lock:
            self._vals.clear()

    def _series(self):
        return [(k, {"buckets": list(st[0]), "sum": st[1],
                     "count": st[2]})
                for k, st in sorted(self._vals.items())]


class MetricsRegistry:
    """Named instrument table. ``counter/gauge/histogram`` are
    get-or-create: subsystems declare their instruments at import time and
    repeated declaration returns the existing one (the registry is
    process-global, like the reference's flag registry)."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as {m.kind}")
                return m
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name) -> Optional[_Metric]:
        return self._metrics.get(name)

    def collect(self) -> List[_Metric]:
        return [self._metrics[k] for k in sorted(self._metrics)]

    def reset(self):
        """Zero every instrument's collected values (instruments and
        callback gauges stay registered) — per-session hygiene for tests
        and repeated profiler runs."""
        for m in self.collect():
            m.clear()

    # ------------------------------------------------------------- export
    def snapshot(self) -> dict:
        """JSON-able dump of every instrument with any data (callback
        gauges are evaluated here, never on the hot path)."""
        out = {}
        for m in self.collect():
            series = m._series()
            if not series:
                continue
            out[m.name] = {
                "kind": m.kind,
                "help": m.help,
                "labelnames": list(m.labelnames),
                "series": [{"labels": list(k), "value": v}
                           for k, v in series],
            }
            if m.kind == "histogram":
                out[m.name]["buckets"] = list(m.buckets)
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format, rendered from snapshot()."""
        return render_prometheus(self.snapshot())


def _esc_label(v) -> str:
    """Prometheus text-format label escaping: backslash, quote, newline."""
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _fmt_labels(names, values, extra=()) -> str:
    pairs = [f'{n}="{_esc_label(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_esc_label(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt_num(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def render_prometheus(snap: dict) -> str:
    """Render a snapshot() dict (live or loaded from a JSON file) as
    Prometheus text exposition."""
    lines: List[str] = []
    for name in sorted(snap):
        m = snap[name]
        if m["help"]:
            lines.append(f"# HELP {name} {m['help']}")
        lines.append(f"# TYPE {name} {m['kind']}")
        names = m.get("labelnames", [])
        for s in m["series"]:
            lv = s["labels"]
            v = s["value"]
            if m["kind"] == "histogram":
                cum = 0
                edges = [*m["buckets"], "+Inf"]
                for ub, n in zip(edges, v["buckets"]):
                    cum += n
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(names, lv, [('le', ub)])} {cum}")
                lines.append(
                    f"{name}_sum{_fmt_labels(names, lv)} "
                    f"{_fmt_num(v['sum'])}")
                lines.append(
                    f"{name}_count{_fmt_labels(names, lv)} {v['count']}")
            else:
                lines.append(
                    f"{name}{_fmt_labels(names, lv)} {_fmt_num(v)}")
    return "\n".join(lines) + ("\n" if lines else "")


#: process-global registry — subsystem instruments live here
REGISTRY = MetricsRegistry()

counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram


# --------------------------------------------------------------------------
# Merging per-process dumps (the .rankN / .pidN fold; the JAX package keeps
# these two in observability/fleet.py)
# --------------------------------------------------------------------------
def merge_snapshots(snaps: Dict[str, dict]) -> dict:
    """Fold per-process snapshots into one whose series carry a leading
    ``rank`` label (``proc`` where the metric has a ``rank`` label of its
    own, so no label name repeats). Histograms keep one series a process.
    The result renders through ``render_prometheus``."""
    out: dict = {}
    for label in sorted(snaps, key=lambda k: (len(str(k)), str(k))):
        snap = snaps[label]
        for name in sorted(snap):
            m = snap[name]
            inner = list(m.get("labelnames", []))
            e = out.setdefault(name, {
                "kind": m.get("kind", "untyped"),
                "help": m.get("help", ""),
                "labelnames": [("proc" if "rank" in inner else "rank")]
                + inner,
                "series": [],
            })
            if "buckets" in m and "buckets" not in e:
                e["buckets"] = list(m["buckets"])
            for s in m.get("series", []):
                e["series"].append({
                    "labels": [str(label)] + [str(v)
                                              for v in s.get("labels", [])],
                    "value": s.get("value"),
                })
    return out


def _suffix_label(base: str, path: str) -> str:
    import re
    suf = path[len(base):].lstrip(".")
    if not suf:
        return "0"                   # the primary keeps the bare path
    m = re.fullmatch(r"rank(\d+)", suf)
    if m:
        return m.group(1)
    m = re.fullmatch(r"rank(\d+)\.(pid\d+)", suf)
    if m:
        return f"{m.group(1)}.{m.group(2)}"
    return suf                       # pidN, or PADDLE_TPU_METRICS_SUFFIX's


def merge_snapshot_files(base: str) -> dict:
    """Fold ``base`` and every ``base.<suffix>`` snapshot file that
    ``PADDLE_TPU_METRICS_DUMP`` wrote into one rank-labeled aggregate. An
    unreadable file is skipped with a note on stderr (a crashed rank's
    half-written dump must not block the healthy ones)."""
    import glob
    import json
    import os
    import sys

    paths = ([base] if os.path.exists(base) else []) + \
        sorted(glob.glob(base + ".*"))
    snaps: Dict[str, dict] = {}
    for p in paths:
        if ".tmp." in os.path.basename(p):
            continue
        try:
            with open(p) as f:
                snaps[_suffix_label(base, p)] = json.load(f)
        except (OSError, ValueError) as e:
            sys.stderr.write(f"[observability] skipping unreadable "
                             f"snapshot {p!r}: {e}\n")
    if not snaps:
        raise FileNotFoundError(
            f"no metric snapshot files found at {base!r} (or {base}.*)")
    return merge_snapshots(snaps)
