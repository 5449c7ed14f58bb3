"""Span buffer: one host timeline across the serving layers (counterpart
of ``paddle_tpu/observability/trace.py``).

Collects complete-span events (``serving.tick`` host spans, the engine's
``serving.prefill``/``serving.decode`` spans) into a bounded in-memory
buffer while it is active; ``tools/loadgen.py`` activates it for a run
and drains it into its report, and the watchdog prints its tail when a
tick stalls. When it is not active every instrumentation site costs one
dict lookup.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["active", "activate", "deactivate", "add_complete", "span",
           "drain", "clear", "MAX_EVENTS"]

#: buffer cap — a runaway loop must degrade to dropped spans, not OOM
MAX_EVENTS = 200_000

# Hot mirror, same contract as metrics.enabled(): dict-lookup cost off.
_active = {"on": False}
_lock = threading.Lock()
_events: List[Tuple[str, str, float, float, int, Optional[dict]]] = []
_dropped = {"n": 0}

_tid_lock = threading.Lock()
_tid_map: Dict[int, int] = {}


def _tid() -> int:
    """Small stable per-thread id for the chrome trace tid column."""
    ident = threading.get_ident()
    t = _tid_map.get(ident)
    if t is None:
        with _tid_lock:
            t = _tid_map.setdefault(ident, len(_tid_map))
    return t


def active() -> bool:
    return _active["on"]


def activate():
    _active["on"] = True


def deactivate():
    _active["on"] = False


def clear():
    with _lock:
        del _events[:]
        _dropped["n"] = 0


def add_complete(name: str, cat: str, t0: float, t1: float,
                 args: Optional[dict] = None):
    """Record one finished span (perf_counter seconds). Caller is expected
    to have checked ``active()`` before paying for the timestamps."""
    if not _active["on"]:
        return
    with _lock:
        if len(_events) >= MAX_EVENTS:
            _dropped["n"] += 1
            return
        _events.append((name, cat, t0, t1, _tid(), args))


class span:
    """Scoped span: ``with trace.span("compile:fn", "compile"): ...``.
    Near-free when inactive (one dict lookup, no timestamps)."""

    __slots__ = ("name", "cat", "args", "_t0")

    def __init__(self, name: str, cat: str = "framework",
                 args: Optional[dict] = None):
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = None

    def __enter__(self):
        if _active["on"]:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            add_complete(self.name, self.cat, self._t0,
                         time.perf_counter(), self.args)
        return False


def drain() -> List[Tuple[str, str, float, float, int, Optional[dict]]]:
    """Return and clear the collected spans (profiler export path)."""
    with _lock:
        out = list(_events)
        del _events[:]
    return out


def tail(n: int = 100) -> List[Tuple[str, str, float, float, int,
                                     Optional[dict]]]:
    """Newest ``n`` spans WITHOUT clearing the buffer — hang/crash
    diagnostics (the watchdog dumps this post-mortem; the profiler's
    export still sees everything)."""
    with _lock:
        return list(_events[-n:]) if n else []


def dropped() -> int:
    return _dropped["n"]
