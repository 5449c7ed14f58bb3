"""Serving telemetry of the PyTorch port (counterpart of
``paddle_tpu/observability``).

- :mod:`.metrics`: a registry of labeled counters, gauges and histograms
  (``FLAGS_enable_metrics`` gates collection at dict-lookup cost) with
  Prometheus text and JSON export;
- :mod:`.trace`: the span buffer the engine's tick and program spans go
  into while it is active;
- :mod:`.reqtrace`: per-request lifecycle timelines, exemplars and SLO
  burn rates (``FLAGS_reqtrace``);
- :mod:`.goodput`: the training run's wall clock in goodput and badput
  buckets (``FLAGS_goodput``);
- :mod:`.sentinel`: online anomaly detection over step time, loss and
  the goodput buckets (``FLAGS_sentinel``).
"""
from __future__ import annotations

from . import goodput, metrics, reqtrace, sentinel, trace
from .metrics import (REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
                      enabled, render_prometheus)

__all__ = ["metrics", "trace", "reqtrace", "goodput", "sentinel", "REGISTRY", "MetricsRegistry",
           "Counter", "Gauge", "Histogram", "enabled", "render_prometheus",
           "snapshot", "to_prometheus"]

snapshot = REGISTRY.snapshot
to_prometheus = REGISTRY.to_prometheus
