"""Per-request incremental token streams (counterpart of
``paddle_tpu/serving/stream.py``).

A serving front door returns tokens as they are generated, not a batch
at completion. :class:`TokenStream` is the shared iterator behind
``PagedEngine.stream(rid)`` and ``Router.stream(rid)``: it reads a delta
buffer the producer appends to every tick, pumps the producer's
``step()`` while the buffer is dry, and terminates exactly when the
request reaches a terminal status — ``stream.status`` then holds it
(``FINISHED``, or the degraded outcome: ``SHED`` / ``DEADLINE_MISSED``
/ ``CANCELLED`` / ``FAILED``). Nothing raises out of iteration; a
stream over a request cancelled by a replica drain simply stops, with
the terminal status readable — the same nothing-raises contract as the
tick loop itself.
"""
from __future__ import annotations

from typing import Callable, List, Optional

__all__ = ["TokenStream"]


class TokenStream:
    """Iterator over one request's tokens as they are generated.

    Args:
      buf: the shared delta list the producer appends tokens to.
      pump: advances the producer one tick (``engine.step`` /
        ``router.step``); called only while the request is live and the
        buffer has no unread tokens.
      status_fn: returns the request's current status string, or ``None``
        once unknown (e.g. outcomes drained elsewhere — treated as
        terminal).
      is_terminal: predicate over status strings.
      max_pumps: backstop on consecutive dry pumps between tokens — a
        wedged producer must fail the stream, not hang the client.
      trace_hook: optional request-trace seam (the producer binds its
        reqtrace scope/clock): called as ``hook(event, **meta)`` with
        ``first_delivery`` when the first token reaches the client and
        ``stream_closed`` at termination — the delivery half of the
        request timeline (tokens can sit generated-but-unread when a
        client attaches late or reads slowly).
    """

    def __init__(self, rid: int, buf: List[int], pump: Callable[[], object],
                 status_fn: Callable[[], Optional[str]],
                 is_terminal: Callable[[Optional[str]], bool],
                 max_pumps: int = 10_000,
                 trace_hook: Optional[Callable[..., None]] = None):
        self.rid = rid
        self.status: Optional[str] = None
        self._buf = buf
        self._pump = pump
        self._status_fn = status_fn
        self._is_terminal = is_terminal
        self._max_pumps = max_pumps
        self._read = 0
        self._final_pump_done = False
        self._trace = trace_hook

    def __iter__(self) -> "TokenStream":
        return self

    def __next__(self) -> int:
        pumps = 0
        while True:
            if self._read < len(self._buf):
                tok = self._buf[self._read]
                self._read += 1
                if self._read == 1 and self._trace is not None:
                    self._trace("first_delivery",
                                buffered=len(self._buf))
                return tok
            status = self._status_fn()
            if status is None or self._is_terminal(status):
                # one last pump so trailing tokens parked between the
                # producer and this buffer (e.g. a replica drained
                # outside the router's step loop) flow in, then drain
                # whatever arrived before closing
                if not self._final_pump_done:
                    self._final_pump_done = True
                    self._pump()
                if self._read < len(self._buf):
                    continue
                self.status = self._status_fn() or status
                if self._trace is not None:
                    self._trace("stream_closed", status=self.status,
                                delivered=self._read)
                    self._trace = None      # close exactly once
                raise StopIteration
            pumps += 1
            if pumps > self._max_pumps:
                # close the timeline's delivery half BEFORE raising: a
                # wedged producer is exactly the failure the request
                # flight recorder exists to diagnose, and an open-ended
                # stream mark would read as a client that walked away
                if self._trace is not None:
                    self._trace("stream_closed", status=status,
                                delivered=self._read,
                                error=f"no progress in "
                                      f"{self._max_pumps} pumps")
                    self._trace = None
                raise RuntimeError(
                    f"stream for request {self.rid} made no progress in "
                    f"{self._max_pumps} ticks (status {status})")
            self._pump()

    def drain(self) -> List[int]:
        """Consume the rest of the stream and return it as a list."""
        return list(self)
