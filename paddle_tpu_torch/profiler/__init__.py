"""paddle.profiler: host and device profiling on the observability layer
(counterpart of ``paddle_tpu/profiler/__init__.py``).

Paddle's profiler (python/paddle/profiler/profiler.py: ``Profiler(targets,
scheduler, on_trace_ready)``, ``RecordEvent``, ``make_scheduler``,
``export_chrome_tracing``), with the device side on ``torch.profiler``
(Kineto over CUPTI) where the JAX package starts ``jax.profiler``. The
host side rides ``paddle_tpu_torch.observability``: the dispatcher's op
hook gives each op's calls and host latency, the span buffer collects
the dispatch, compile, collective and user ranges, and
``export_chrome_tracing`` writes them as one Chrome trace, with the
device trace (the card's kernels) beside it in the same directory.
``timer_only`` reports step throughput (steps/s, examples/s) without a
trace.

With ``ProfilerTarget.GPU`` among the targets and CUDA present, the
recording window starts a ``torch.profiler`` session of the card's
activity, after a synchronize (and ends it after another, so every
kernel of the window is in it); a session that cannot start raises. On
a host without CUDA there is no card to trace and only the host side
records.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from enum import Enum
from typing import Callable, Iterable, Optional

import torch

from ..observability import metrics as _metrics
from ..observability import trace as _trace

__all__ = ["Profiler", "ProfilerTarget", "ProfilerState", "RecordEvent",
           "SortedKeys", "make_scheduler", "export_chrome_tracing",
           "profile"]


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    CUSTOM_DEVICE = 3


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class SortedKeys(Enum):
    """Summary sort orders (Paddle's ``profiler.SortedKeys``, the host
    timeline's; the card's times are in the device trace)."""
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    Calls = 3


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    """Paddle's ``make_scheduler``: the step -> state machine."""
    cycle = closed + ready + record

    def scheduler(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        step -= skip_first
        if repeat and step >= repeat * cycle:
            return ProfilerState.CLOSED
        pos = step % cycle
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == cycle - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


#: Chrome-trace tid blocks by span category, so each instrumented layer
#: is a named row in the viewer (500 is the unknown-category lane)
_CAT_TID_BASE = {"user": 0, "dispatch": 100, "compile": 200,
                 "collective": 300, "autotune": 400,
                 "io": 600, "device": 700}


def _trace_rank() -> Optional[int]:
    """This process's trainer rank from the launcher's environment, or
    None outside a launcher (rank 0 of a launch still reports 0, so its
    file name globs with its peers')."""
    from ..observability.flight import env_rank
    return env_rank()


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    """An ``on_trace_ready`` callback writing one Chrome trace of the host
    (``<worker>_host_ops.json``: the RecordEvent ranges and every span
    the tracer collected while recording: dispatched ops, to_static and
    SOT compiles, collectives) and, where the device tracer ran, the
    card's trace beside it (``<worker>_device.json``, torch.profiler's
    Chrome export). In a distributed launch the default worker name
    carries the rank (``worker_r1``). The host file's ``clock_sync``
    metadata has ``offset_vs_rank0_s: null``: the port has no clock sync
    across ranks yet."""
    def handler(prof: "Profiler"):
        os.makedirs(dir_name, exist_ok=True)
        rank = _trace_rank()
        default_name = "worker" if rank is None else f"worker_r{rank}"
        rank = rank or 0
        worker = worker_name or default_name
        fname = os.path.join(dir_name, f"{worker}_host_ops.json")
        events = []
        for name, t0, t1 in prof._events:
            events.append({"name": name, "cat": "user", "ph": "X",
                           "pid": 0, "tid": 0,
                           "ts": int(t0 * 1e6),
                           "dur": max(int((t1 - t0) * 1e6), 0)})
        for name, cat, t0, t1, tid, args in prof._spans:
            ev = {"name": name, "cat": cat, "ph": "X", "pid": 0,
                  "tid": _CAT_TID_BASE.get(cat, 500) + tid,
                  "ts": int(t0 * 1e6),
                  "dur": max(int((t1 - t0) * 1e6), 0)}
            if args:
                ev["args"] = dict(args)
            events.append(ev)
        events.sort(key=lambda e: (e["ts"], e["tid"]))
        meta = [{"name": "process_name", "ph": "M", "pid": 0,
                 "args": {"name": "paddle_tpu host"
                          + (f" (rank {rank})" if rank else "")}},
                {"name": "clock_sync", "ph": "M", "pid": 0,
                 "args": {"rank": rank, "offset_vs_rank0_s": None}}]
        if prof._spans_dropped:
            # the buffer overflowed: the timeline is incomplete
            meta.append({"name": "spans_dropped", "ph": "M", "pid": 0,
                         "args": {"count": prof._spans_dropped}})
        meta += [{"name": "thread_name", "ph": "M", "pid": 0,
                  "tid": base, "args": {"name": cat}}
                 for cat, base in sorted(_CAT_TID_BASE.items(),
                                         key=lambda kv: kv[1])]
        with open(fname, "w") as f:
            json.dump({"traceEvents": meta + events}, f)
        prof.trace_path = fname
        if prof._device_prof is not None:
            dname = os.path.join(dir_name, f"{worker}_device.json")
            prof._device_prof.export_chrome_trace(dname)
            prof.device_trace_path = dname
    return handler


class RecordEvent:
    """A user range (Paddle's ``profiler.utils.RecordEvent``): it shows in
    the host-op summary and the host trace and, while the device tracer
    runs, as a ``record_function`` range in the device trace."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._dev_ctx = None
        self._t0 = None

    def begin(self):
        self._t0 = time.perf_counter()
        if _ACTIVE is not None and _ACTIVE._device_tracing:
            self._dev_ctx = torch.profiler.record_function(self.name)
            self._dev_ctx.__enter__()

    def end(self):
        if self._dev_ctx is not None:
            self._dev_ctx.__exit__(None, None, None)
            self._dev_ctx = None
        if self._t0 is None:
            return
        t1 = time.perf_counter()
        if _ACTIVE is not None:
            # the active profiler exports its _events itself (the trace
            # buffer too would render every user range twice), those of
            # its record window only: the JAX package keeps every
            # range of the session, so a scheduler's closed and ready
            # steps showed in the trace of its window
            if _ACTIVE._state in (ProfilerState.RECORD,
                                  ProfilerState.RECORD_AND_RETURN):
                _ACTIVE._events.append((self.name, self._t0, t1))
        else:
            _trace.add_complete(self.name, "user", self._t0, t1)
        self._t0 = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


_ACTIVE: Optional["Profiler"] = None

# step-timer metrics (FLAGS_enable_metrics gates their collection)
_m_steps = _metrics.counter(
    "paddle_tpu_train_steps_total",
    "Profiler-observed training steps.")
_m_step_time = _metrics.histogram(
    "paddle_tpu_train_step_seconds", "Wall time per training step.")
_m_steps_per_s = _metrics.gauge(
    "paddle_tpu_steps_per_second",
    "Throughput of the most recent profiler-observed step.")
_m_examples_per_s = _metrics.gauge(
    "paddle_tpu_examples_per_second",
    "Examples/sec of the most recent step (step() called with "
    "num_samples).")


def _card_present() -> bool:
    return torch.cuda.is_available()


class Profiler:
    """Paddle's ``Profiler`` (profiler.py:79)::

        with profiler.Profiler(targets=[...], scheduler=(2, 5)) as p:
            for step, batch in enumerate(loader):
                train_step(batch)
                p.step(num_samples=batch_size)
        p.summary()
    """

    def __init__(self, *, targets: Optional[Iterable] = None,
                 scheduler=None, on_trace_ready: Optional[Callable] = None,
                 timer_only: bool = False, record_shapes: bool = False,
                 profile_memory: bool = False, with_flops: bool = False):
        self.targets = list(targets or [ProfilerTarget.CPU,
                                        ProfilerTarget.GPU])
        if isinstance(scheduler, tuple):
            start, end = scheduler
            scheduler = make_scheduler(closed=max(start, 0), ready=0,
                                       record=end - start, repeat=1)
        self.scheduler = scheduler or (lambda step: ProfilerState.RECORD)
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self._step = 0
        self._state = ProfilerState.CLOSED
        self._events = []                 # RecordEvent: (name, t0, t1)
        self._spans = []                  # harvested observability spans
        self._spans_dropped = 0
        self._op_stats = defaultdict(lambda: [0, 0.0, 0.0])  # n, total, max
        self._step_times = []
        self._step_samples = []
        self._step_t0 = None
        self._hook_handle = None
        self._device_prof = None          # torch.profiler.profile
        self._device_tracing = False
        self._host_tracing = False
        self.trace_path = None
        self.device_trace_path = None

    # ---------------------------------------------------------------- hooks
    def _op_hook(self, op_name, inputs, outputs, attrs, duration=0.0):
        if self._state in (ProfilerState.RECORD,
                           ProfilerState.RECORD_AND_RETURN):
            st = self._op_stats[op_name]
            st[0] += 1
            st[1] += duration
            if duration > st[2]:
                st[2] = duration

    # ---------------------------------------------------------------- state
    def start(self):
        global _ACTIVE
        _ACTIVE = self
        # a restarted profiler must not report the previous session's
        # events, op stats or step times
        self._events = []
        self._spans = []
        self._spans_dropped = 0
        self._op_stats = defaultdict(lambda: [0, 0.0, 0.0])
        self._step_times = []
        self._step_samples = []
        self._step = 0
        self._device_prof = None
        self._step_t0 = time.perf_counter()
        from ..core import dispatch
        if self._hook_handle is None:
            dispatch.register_op_hook(self._op_hook)
            self._hook_handle = self._op_hook
        self._transition(self.scheduler(self._step))
        return self

    def stop(self):
        global _ACTIVE
        self._transition(ProfilerState.CLOSED)
        if self._hook_handle is not None:
            from ..core import dispatch
            dispatch.unregister_op_hook(self._hook_handle)
            self._hook_handle = None
        _ACTIVE = None
        if self.on_trace_ready is not None:
            self.on_trace_ready(self)

    def step(self, num_samples: Optional[int] = None):
        now = time.perf_counter()
        if self._step_t0 is not None:
            dt = now - self._step_t0
            self._step_times.append(dt)
            if num_samples:
                self._step_samples.append(num_samples)
            if _metrics.enabled() and dt > 0:
                _m_steps.inc()
                _m_step_time.observe(dt)
                _m_steps_per_s.set(1.0 / dt)
                if num_samples:
                    _m_examples_per_s.set(num_samples / dt)
        self._step_t0 = now
        self._step += 1
        self._transition(self.scheduler(self._step))

    def _start_device_trace(self):
        """The card's activity from here on (torch.profiler, CUDA
        activity): after a synchronize, so the window holds its own
        kernels; raises when the session cannot start."""
        torch.cuda.synchronize()
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        try:
            prof.__enter__()
        except Exception as e:
            raise RuntimeError(
                f"profiler: the device tracer (torch.profiler, CUDA "
                f"activity) did not start: {e}") from e
        self._device_prof = prof
        self._device_tracing = True

    def _stop_device_trace(self):
        torch.cuda.synchronize()        # every kernel of the window ends
        self._device_prof.__exit__(None, None, None)
        self._device_tracing = False

    def _transition(self, new_state: ProfilerState):
        was_rec = self._state in (ProfilerState.RECORD,
                                  ProfilerState.RECORD_AND_RETURN)
        now_rec = new_state in (ProfilerState.RECORD,
                                ProfilerState.RECORD_AND_RETURN)
        if now_rec and not was_rec and not self.timer_only:
            # the host spans ride the device trace's window; the
            # RecordEvent and op stats are collected by the hooks
            _trace.clear()
            _trace.activate()
            self._host_tracing = True
            if ProfilerTarget.GPU in self.targets and _card_present():
                self._start_device_trace()
        if was_rec and not now_rec:
            if self._host_tracing:
                _trace.deactivate()
                self._spans_dropped += _trace.dropped()
                self._spans.extend(_trace.drain())
                self._host_tracing = False
                if self._spans_dropped:
                    import warnings
                    warnings.warn(
                        f"profiler span buffer overflowed: "
                        f"{self._spans_dropped} span(s) dropped — the "
                        f"exported timeline is truncated (shorten the "
                        f"record window)")
            if self._device_tracing:
                self._stop_device_trace()
        self._state = new_state

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -------------------------------------------------------------- report
    def step_info(self, unit: Optional[str] = None) -> str:
        """Throughput line (Paddle's ``profiler/timer.py``
        ``benchmark().step_info``)."""
        if not self._step_times:
            return "no steps recorded"
        n = len(self._step_times)
        total = sum(self._step_times)
        avg = total / n
        ips = (1.0 / avg) if avg > 0 else 0.0
        out = (f"steps: {n} avg_step: {avg * 1e3:.3f} ms "
               f"steps/sec: {ips:.3f}")
        if self._step_samples and total > 0:
            out += (f" {unit or 'examples'}/sec: "
                    f"{sum(self._step_samples) / total:.3f}")
        elif unit:
            out += f" {unit}/sec: {ips:.3f}"
        return out

    @staticmethod
    def _sort_key(sorted_by):
        if sorted_by in (None, SortedKeys.CPUTotal, "time", "cpu_total"):
            return lambda kv: -kv[1][1]
        if sorted_by in (SortedKeys.Calls, "calls"):
            return lambda kv: -kv[1][0]
        if sorted_by in (SortedKeys.CPUAvg, "avg", "cpu_avg"):
            return lambda kv: -(kv[1][1] / kv[1][0] if kv[1][0] else 0.0)
        if sorted_by in (SortedKeys.CPUMax, "max", "cpu_max"):
            return lambda kv: -kv[1][2]
        raise ValueError(f"unsupported sorted_by {sorted_by!r}")

    def summary(self, sorted_by=None, op_detail: bool = True,
                thread_sep: bool = False, time_unit: str = "ms"):
        """Print the host-op table (calls and host latency from the
        dispatch hook) and the step throughput. Returns ``{op_name:
        calls}``."""
        scale = {"s": 1.0, "ms": 1e3, "us": 1e6}.get(time_unit, 1e3)
        rows = sorted(self._op_stats.items(), key=self._sort_key(sorted_by))
        line = "-" * 78
        print(line)
        print(f"{'op':<32}{'calls':>8}{'total(' + time_unit + ')':>14}"
              f"{'avg(' + time_unit + ')':>12}{'max(' + time_unit + ')':>12}")
        print(line)
        for name, (n, tot, mx) in rows[:40]:
            avg = tot / n if n else 0.0
            print(f"{name:<32}{n:>8}{tot * scale:>14.3f}"
                  f"{avg * scale:>12.3f}{mx * scale:>12.3f}")
        print(line)
        if self._step_times:
            print(self.step_info())
        if self._events:
            print("user ranges:")
            for name, t0, t1 in self._events[:20]:
                print(f"  {name}: {(t1 - t0) * 1e3:.3f} ms")
        return {name: n for name, (n, _tot, _mx) in rows}

    def op_stats(self) -> dict:
        """Per-op host stats: ``{op: {"calls", "total_s", "max_s"}}``."""
        return {name: {"calls": n, "total_s": tot, "max_s": mx}
                for name, (n, tot, mx) in self._op_stats.items()}


@contextlib.contextmanager
def profile(**kwargs):
    p = Profiler(**kwargs)
    p.start()
    try:
        yield p
    finally:
        p.stop()
