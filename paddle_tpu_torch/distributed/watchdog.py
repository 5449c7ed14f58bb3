"""Progress watchdog: hang detection and diagnostics (counterpart of the
part of ``paddle_tpu/distributed/watchdog.py`` that the serving engine
uses).

The watchdog watches progress: ``begin_work``/``end_work`` bracket work
in flight (the engine brackets every tick) and each of them, like
``heartbeat()``, stamps the time. A daemon thread fires when no progress
happens for ``timeout`` seconds while work is in flight: it dumps every
Python thread's stack, the span buffer's tail, a metrics snapshot and
the requests caught mid-flight, then calls ``on_hang(watchdog)``.

The JAX package's ``start()`` also hooks every dispatched op as a
heartbeat, and its hang path diffs the collective flight records of all
ranks and can abort the process; the port has neither an op dispatcher
nor collectives yet, so only the engine's brackets feed it.
"""
from __future__ import annotations

import faulthandler
import json
import sys
import threading
import time
from typing import Callable, Optional

__all__ = ["Watchdog"]


class Watchdog:
    def __init__(self, timeout: float = 600.0,
                 on_hang: Optional[Callable] = None,
                 poll_interval: float = 5.0):
        self.timeout = timeout
        self.on_hang = on_hang
        self.poll_interval = poll_interval
        self._last_progress = time.monotonic()
        self._in_flight = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.hang_count = 0
        self.unbalanced_end_count = 0

    # ------------------------------------------------------------- progress
    def heartbeat(self):
        with self._lock:
            self._last_progress = time.monotonic()

    def begin_work(self):
        with self._lock:
            self._in_flight += 1
            self._last_progress = time.monotonic()

    def end_work(self):
        with self._lock:
            if self._in_flight == 0:
                # an unbalanced end_work (double finally, crashed begin):
                # a counter gone negative would make a later begin_work
                # read as no work in flight and blind the detector, so
                # clamp it and count the imbalance for the diagnostics
                self.unbalanced_end_count += 1
            else:
                self._in_flight -= 1
            self._last_progress = time.monotonic()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "Watchdog":
        def run():
            while not self._stop.wait(self.poll_interval):
                with self._lock:
                    stalled = (self._in_flight > 0 and
                               time.monotonic() - self._last_progress
                               > self.timeout)
                if stalled:
                    self._report()
                    self.heartbeat()   # one report per stall window

        self._stop.clear()
        self._thread = threading.Thread(target=run, daemon=True,
                                        name="paddle_tpu_torch_watchdog")
        self._thread.start()
        return self

    def _report(self):
        self.hang_count += 1
        sys.stderr.write(f"[watchdog] no progress for >{self.timeout}s with "
                         f"work in flight — dumping thread stacks\n")
        faulthandler.dump_traceback(file=sys.stderr)
        try:
            self.dump_diagnostics()
        except Exception:
            pass   # diagnostics must never mask the hang
        if self.on_hang is not None:
            try:
                self.on_hang(self)
            except Exception:
                pass

    def dump_diagnostics(self, file=None):
        """Post-mortem context for a hang: the span buffer's tail, a
        metrics snapshot, the serving requests caught mid-flight and a
        persisted request-trace record (``PADDLE_TPU_REQTRACE``)."""
        from ..observability import REGISTRY, reqtrace, trace

        out = file or sys.stderr
        out.write("[watchdog] ---- hang diagnostics ----\n")
        if self.unbalanced_end_count:
            out.write(f"[watchdog] WARNING: {self.unbalanced_end_count} "
                      f"unbalanced end_work() call(s) — begin/end "
                      f"bracketing is broken somewhere\n")
        spans = trace.tail(50)
        out.write(f"[watchdog] span buffer tail ({len(spans)} spans):\n")
        for name, cat, t0, t1, tid, args in spans:
            out.write(f"[watchdog]   {cat}:{name} dur={t1 - t0:.6f}s "
                      f"tid={tid}\n")
        out.write("[watchdog] metrics snapshot: "
                  + json.dumps(REGISTRY.snapshot(), sort_keys=True,
                               default=str) + "\n")
        live = reqtrace.RECORDER.live_timelines()
        if live:
            out.write(f"[watchdog] {len(live)} request(s) mid-flight "
                      f"(no terminal event):\n")
            for tl in live[:10]:
                evs = tl["events"]
                last = evs[-1] if evs else None
                out.write(
                    f"[watchdog]   {tl['scope']}/rid={tl['rid']} "
                    f"{len(evs)} events, last="
                    + (f"{last['event']}@{last['t']:.3f}" if last
                       else "<none>") + "\n")
        path = reqtrace.dump(reason=f"watchdog hang #{self.hang_count}")
        if path:
            out.write(f"[watchdog] request-trace record persisted: "
                      f"{path}\n")
        out.write("[watchdog] ---- end diagnostics ----\n")

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.poll_interval)
            self._thread = None

    def __enter__(self):
        self.begin_work()
        return self

    def __exit__(self, *exc):
        self.end_work()
        return False
