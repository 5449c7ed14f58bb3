"""Double-buffered device prefetch (counterpart of
``paddle_tpu/io/prefetch.py``).

A background thread pulls the next batch from any iterator and places it
on the device while the current step computes, keeping up to ``depth``
batches in flight; the consumer's ``next()`` is a queue pop.
``hapi.Model.fit`` wraps its loader in one (``FLAGS_prefetch``), handing
it host batches (``DataLoader.iter(host=True)``).

On the card the copy runs on a side CUDA stream of the prefetcher's, on
the producer thread, from pinned host memory with ``non_blocking=True``;
an event recorded after each batch's copy is what the consumer's stream
waits on (``wait_event``, the one-batch form of ``wait_stream``) before
the batch is handed out, and every tensor of the batch is
``record_stream``-ed on the consumer's stream, so the caching allocator
does not reuse its memory while the step still reads it. Without that
wait a step could read a half-copied batch.

Telemetry, the JAX package's: ``paddle_tpu_prefetch_depth``,
``paddle_tpu_prefetch_hits_total`` (the batch was ready when asked),
``paddle_tpu_prefetch_stall_seconds_total``, ``io.prefetch`` spans on
the producer thread, and a stall billed to the goodput ledger's
``data_stall`` bucket. ``transfer_counts()`` counts the batches the
prefetchers of this process placed and the host tensors they copied to
a device.

Shutdown: the producer thread and the wrapped iterator are torn down
together, by ``close``/``with``, at exhaustion, and by
``weakref.finalize`` when the consumer abandons the prefetcher; a wrapped
multiprocess DataLoader iterator then stops its workers.
"""
from __future__ import annotations

import functools
import queue as queue_mod
import threading
import time
import weakref
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..core import flags
from ..core.place import current_device
from ..core.tensor import Tensor, as_tensor
from ..observability import goodput as _goodput
from ..observability import metrics as _metrics
from ..observability import trace as _trace

__all__ = ["DevicePrefetcher", "default_place_fn", "transfer_counts"]

_m_depth = _metrics.gauge(
    "paddle_tpu_prefetch_depth",
    "Configured DevicePrefetcher depth (batches kept in flight).")
_m_hits = _metrics.counter(
    "paddle_tpu_prefetch_hits_total",
    "Batches already transferred when the consumer asked (no wait).")
_m_stall = _metrics.counter(
    "paddle_tpu_prefetch_stall_seconds_total",
    "Seconds the consumer waited because the producer was behind.")

_DONE = object()
_counts = {"batches": 0, "host_to_device": 0}
_counts_lock = threading.Lock()


def transfer_counts() -> dict:
    """{"batches": batches placed by prefetchers, "host_to_device": host
    tensors they copied to a device} in this process so far."""
    with _counts_lock:
        return dict(_counts)


def default_place_fn(batch, device=None):
    """Every Tensor, torch.Tensor and numpy leaf on ``device`` (the
    current device when None), the structure kept. A host tensor is
    copied with ``non_blocking`` (asynchronous from pinned memory)."""
    dev = current_device() if device is None else torch.device(device)
    if isinstance(batch, Tensor):
        d = batch._data
        if d.device == dev:
            return batch
        return Tensor(_to_device(d, dev), stop_gradient=batch.stop_gradient)
    if isinstance(batch, torch.Tensor):
        return batch if batch.device == dev else _to_device(batch, dev)
    if isinstance(batch, np.ndarray):
        return Tensor(_to_device(as_tensor(batch, device="cpu")._data, dev))
    if isinstance(batch, (list, tuple)):
        return type(batch)(default_place_fn(b, dev) for b in batch)
    if isinstance(batch, dict):
        return {k: default_place_fn(v, dev) for k, v in batch.items()}
    return batch


def _to_device(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    with _counts_lock:
        _counts["host_to_device"] += 1
    return t.to(dev, non_blocking=True)


def _leaves(batch):
    if isinstance(batch, Tensor):
        yield batch._data
    elif isinstance(batch, torch.Tensor):
        yield batch
    elif isinstance(batch, (list, tuple)):
        for b in batch:
            yield from _leaves(b)
    elif isinstance(batch, dict):
        for b in batch.values():
            yield from _leaves(b)


def _teardown_inner(it):
    """Propagate shutdown to the wrapped iterator (a multiprocess
    DataLoader iterator stops its workers)."""
    for name in ("close", "_teardown"):
        fn = getattr(it, name, None)
        if callable(fn):
            try:
                fn()
            except Exception:
                pass
            return


def _producer_loop(it, q, stop, place_fn, stream):
    """Fetch and place the next batch, then park it (with the event
    recorded after its copy) in the bounded queue. Holds no reference to
    the prefetcher, so that it stays collectable."""
    try:
        while not stop.is_set():
            try:
                with _trace.span("io.prefetch", "io"):
                    batch = next(it)
                    if stream is None:
                        placed, event = place_fn(batch), None
                    else:
                        with torch.cuda.stream(stream):
                            placed = place_fn(batch)
                            event = torch.cuda.Event()
                            event.record(stream)
                with _counts_lock:
                    _counts["batches"] += 1
            except StopIteration:
                _offer(q, (_DONE, None, None), stop)
                return
            except BaseException as e:  # surface in the consumer
                _offer(q, ("error", e, None), stop)
                return
            if not _offer(q, ("ok", placed, event), stop):
                return
    finally:
        if stop.is_set():
            _teardown_inner(it)


def _offer(q, item, stop) -> bool:
    """put() that never blocks shutdown: re-checks the stop event while
    the queue is full."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue_mod.Full:
            continue
    return False


def _shutdown(stop, thread, it):
    """finalize/close target (module-level: must not reference the
    prefetcher). Signals the producer, waits briefly, and tears down the
    wrapped iterator even if the producer is parked."""
    stop.set()
    thread.join(timeout=5.0)
    _teardown_inner(it)


class DevicePrefetcher:
    """Wrap ``it`` so that batches are fetched and placed ``depth`` steps
    ahead of the consumer (``FLAGS_prefetch_depth`` when None).
    ``place_fn(batch)`` runs on the producer thread; the default puts
    every leaf on ``device`` (the current device when None), on the
    card through a side stream."""

    def __init__(self, it: Iterator, depth: Optional[int] = None,
                 place_fn: Optional[Callable] = None, device=None):
        if depth is None:
            depth = int(flags.get_flag("prefetch_depth"))
        self.depth = max(1, int(depth))
        self.device = current_device() if device is None else \
            torch.device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._queue: queue_mod.Queue = queue_mod.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._done = False
        self.hits = 0
        self.stall_seconds = 0.0
        if _metrics.enabled():
            _m_depth.set(self.depth)
        inner = iter(it)
        self._thread = threading.Thread(
            target=_producer_loop,
            args=(inner, self._queue, self._stop,
                  place_fn or functools.partial(default_place_fn,
                                                device=self.device),
                  self._stream),
            name="paddle_tpu-prefetch", daemon=True)
        self._finalizer = weakref.finalize(
            self, _shutdown, self._stop, self._thread, inner)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        waited = False
        try:
            kind, payload, event = self._queue.get_nowait()
        except queue_mod.Empty:
            waited = True
            t0 = time.perf_counter()
            while True:
                try:
                    kind, payload, event = self._queue.get(timeout=1.0)
                    break
                except queue_mod.Empty:
                    # a closed prefetcher, or a dead producer that parked
                    # no sentinel, must not hang the consumer
                    if self._stop.is_set() or not self._thread.is_alive():
                        self._done = True
                        raise StopIteration
            stalled = time.perf_counter() - t0
            self.stall_seconds += stalled
            if _metrics.enabled():
                _m_stall.inc(stalled)
            _goodput.bill_interval("data_stall", t0, t0 + stalled)
        if kind is _DONE:
            self._done = True
            self.close()
            raise StopIteration
        if kind == "error":
            self._done = True
            self.close()
            raise payload
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in _leaves(payload):
                if t.device.type == "cuda":
                    t.record_stream(consumer)
        if not waited:
            self.hits += 1
            if _metrics.enabled():
                _m_hits.inc()
        return payload

    def close(self):
        """Stop the producer and tear down the wrapped iterator
        (idempotent; also runs at garbage collection and exit)."""
        self._finalizer()

    @property
    def closed(self) -> bool:
        return not self._finalizer.alive

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
