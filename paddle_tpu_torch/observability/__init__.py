"""Serving telemetry of the PyTorch port (counterpart of
``paddle_tpu/observability``).

- :mod:`.metrics`: a registry of labeled counters, gauges and histograms
  (``FLAGS_enable_metrics`` gates collection at dict-lookup cost) with
  Prometheus text and JSON export;
- :mod:`.trace`: the span buffer the engine's tick and program spans go
  into while it is active;
- :mod:`.reqtrace`: per-request lifecycle timelines, exemplars and SLO
  burn rates (``FLAGS_reqtrace``).
"""
from __future__ import annotations

from . import metrics, reqtrace, trace
from .metrics import (REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
                      enabled, render_prometheus)

__all__ = ["metrics", "trace", "reqtrace", "REGISTRY", "MetricsRegistry",
           "Counter", "Gauge", "Histogram", "enabled", "render_prometheus",
           "snapshot", "to_prometheus"]

snapshot = REGISTRY.snapshot
to_prometheus = REGISTRY.to_prometheus
