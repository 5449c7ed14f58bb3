"""Telemetry of the PyTorch port (counterpart of
``paddle_tpu/observability``).

- :mod:`.metrics`: a registry of labeled counters, gauges and histograms
  (``FLAGS_enable_metrics`` gates collection at dict-lookup cost) with
  Prometheus text and JSON export;
- :mod:`.trace`: the span buffer the dispatcher, the collectives, the
  engine and the profiler's ranges go into while it is active;
- :mod:`.reqtrace`: per-request lifecycle timelines, exemplars and SLO
  burn rates (``FLAGS_reqtrace``);
- :mod:`.goodput`: the training run's wall clock in goodput and badput
  buckets (``FLAGS_goodput``);
- :mod:`.sentinel`: online anomaly detection over step time, loss and
  the goodput buckets (``FLAGS_sentinel``);
- :mod:`.flight`: the collective flight recorder and its cross-rank
  diff;
- :mod:`.perf`: the cost model, device timing and step attribution, and
  the attributed device-memory census.

CLI: ``python -m paddle_tpu_torch.observability`` prints the Prometheus
or JSON snapshot of the current process, of a file written through
``PADDLE_TPU_METRICS_DUMP=/path FLAGS_enable_metrics=1``, or of such a
file merged with its per-process siblings (``--merge``).
"""
from __future__ import annotations

import os

from . import metrics, trace
from . import flight  # noqa: F401  (registers the flight-record exit dump)
from . import goodput, reqtrace, sentinel
from .metrics import (REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
                      enabled, render_prometheus)

__all__ = ["metrics", "trace", "flight", "reqtrace", "goodput", "sentinel",
           "REGISTRY", "MetricsRegistry", "Counter", "Gauge", "Histogram",
           "enabled", "render_prometheus", "device_live_bytes", "snapshot",
           "to_prometheus"]

snapshot = REGISTRY.snapshot
to_prometheus = REGISTRY.to_prometheus


def device_live_bytes() -> float:
    """Bytes the CUDA caching allocator holds for live tensors, over the
    initialized cards (0 without CUDA); read at snapshot time only."""
    try:
        import torch
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return 0.0
        return float(sum(torch.cuda.memory_allocated(d)
                         for d in range(torch.cuda.device_count())))
    except Exception:
        return 0.0


metrics.gauge(
    "paddle_tpu_device_live_bytes",
    "Bytes the CUDA allocator holds for live tensors (every initialized "
    "card), read at snapshot time.").set_function(device_live_bytes)


# The pid that first imported this module owns the bare dump path; it is
# published through the environment so that fork- and spawn-started
# children (which import the module again) know they are not the primary
# process.
_PRIMARY_PID_ENV = "PADDLE_TPU_METRICS_PRIMARY_PID"
os.environ.setdefault(_PRIMARY_PID_ENV, str(os.getpid()))


def _dump_path(path: str) -> str:
    """Process-unique dump path: in a run of many processes (distributed
    ranks, forked loader workers) each writes its own file. The primary
    process keeps ``path``; a rank above 0 adds ``.rankN``, a process
    that is not the primary ``.pidN``; ``PADDLE_TPU_METRICS_SUFFIX``
    always wins."""
    suffix = os.environ.get("PADDLE_TPU_METRICS_SUFFIX")
    if suffix is not None:
        return f"{path}.{suffix}"
    parts = []
    for var in ("PADDLE_TRAINER_ID", "RANK"):
        v = os.environ.get(var)
        if v is not None and v.strip().isdigit() and int(v) > 0:
            parts.append(f"rank{int(v)}")
            break
    if os.environ.get(_PRIMARY_PID_ENV) != str(os.getpid()):
        # a worker of rank N must not overwrite rank N's own file
        parts.append(f"pid{os.getpid()}")
    return ".".join([path] + parts)


def _install_exit_dump():
    """``PADDLE_TPU_METRICS_DUMP=/path``: write the JSON snapshot at
    process exit (after a census refresh, so the attributed memory gauges
    ride in it), for ``python -m paddle_tpu_torch.observability --input
    /path``."""
    path = os.environ.get("PADDLE_TPU_METRICS_DUMP")
    if not path:
        return

    import atexit
    import json

    def _dump():
        try:
            from .perf import memory as _perf_memory
            _perf_memory.refresh_metrics()
        except Exception:
            pass
        try:
            with open(_dump_path(path), "w") as f:
                json.dump(REGISTRY.snapshot(), f, indent=1, sort_keys=True)
        except OSError:
            pass

    atexit.register(_dump)


_install_exit_dump()
