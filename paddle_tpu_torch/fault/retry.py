"""Retry with exponential backoff, jitter and a deadline (counterpart of
``paddle_tpu/fault/retry.py``, the JAX package's code).

Used by checkpoint I/O and the host-side object collectives: transient
filesystem and peer failures (NFS hiccup, preempted host, stuck gRPC
channel) are retried on a bounded schedule; a *persistent* failure
surfaces the ORIGINAL exception — never a wrapper — so callers and tests
see the real error class (the Megatron-LM/PaLM practice of bounded
recovery, then fail loudly).

The sleep and clock are injectable seams (``sleep=``/``clock=``) so tier-1
tests verify the exact backoff schedule without a single real sleep, and
jitter comes from an explicit ``random.Random`` so the schedule is
deterministic under test.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type

from ..observability import metrics as _metrics

__all__ = ["RetryPolicy", "retry"]

_m_retries = _metrics.counter(
    "paddle_tpu_fault_retries_total",
    "Retried attempts per call site (checkpoint I/O, object collectives).",
    labelnames=("site",))


class RetryPolicy:
    """Backoff schedule: delay(k) = min(base * multiplier**k, max_delay),
    scaled by up to ±``jitter`` fraction; at most ``max_attempts`` total
    attempts and (optionally) a wall-clock ``deadline`` in seconds across
    the whole call."""

    __slots__ = ("max_attempts", "base_delay", "multiplier", "max_delay",
                 "jitter", "deadline", "retry_on")

    def __init__(self, max_attempts: int = 3, base_delay: float = 0.05,
                 multiplier: float = 2.0, max_delay: float = 2.0,
                 jitter: float = 0.1, deadline: Optional[float] = None,
                 retry_on: Tuple[Type[BaseException], ...] = (
                     OSError, TimeoutError)):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.multiplier = float(multiplier)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self.deadline = deadline
        self.retry_on = tuple(retry_on)

    def delay(self, attempt: int, rng: random.Random) -> float:
        """Backoff before retry number ``attempt`` (0-based)."""
        d = min(self.base_delay * self.multiplier ** attempt, self.max_delay)
        if self.jitter:
            d *= 1.0 + rng.uniform(-self.jitter, self.jitter)
        return max(d, 0.0)


def retry(fn: Callable, policy: Optional[RetryPolicy] = None,
          site: str = "", sleep: Optional[Callable[[float], None]] = None,
          clock: Optional[Callable[[], float]] = None,
          rng: Optional[random.Random] = None):
    """Call ``fn()``; on an exception in ``policy.retry_on``, back off and
    retry up to the attempt/deadline budget, then re-raise the original.

    Each retried attempt increments ``paddle_tpu_fault_retries_total``
    (label: ``site``) so persistent flakiness is visible on dashboards
    long before it becomes an outage.
    """
    policy = policy or RetryPolicy()
    sleep = time.sleep if sleep is None else sleep
    clock = time.monotonic if clock is None else clock
    rng = random.Random(0) if rng is None else rng
    site = site or getattr(fn, "__name__", "fn")
    start = clock()
    attempt = 0
    while True:
        try:
            return fn()
        except policy.retry_on:
            attempt += 1
            if attempt >= policy.max_attempts:
                raise
            d = policy.delay(attempt - 1, rng)
            if policy.deadline is not None and \
                    clock() - start + d > policy.deadline:
                raise
            _m_retries.inc(site=site)
            sleep(d)
