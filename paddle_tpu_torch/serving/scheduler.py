"""Phase-split tick scheduling: chunked prefill budgeted against decode
(counterpart of ``paddle_tpu/serving/scheduler.py``).

An engine that prefills every admitted prompt to its end inside the
admission tick stalls the decode batch for the whole prompt. Here prompts
advance in ``block_size`` chunks under a per-tick token budget, and the
batched decode step runs every tick whatever prefill is pending: decode
first, prefill gets the budget. ``prefill_token_budget=None`` keeps the
unbudgeted behaviour (every pending chunk in the admission tick).

The scheduler keeps its totals locally (``prefill_tokens``,
``decode_tokens``, ``deferred_chunks``, ``phase_share()``). The JAX
package also exports them as process-wide metrics counters; the port's
metrics registry comes with a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

__all__ = ["SchedulerConfig", "Scheduler"]


@dataclass
class SchedulerConfig:
    """Knobs for the phase-split tick scheduler.

    ``prefill_token_budget``
        Upper bound on prompt tokens advanced per tick across the batch
        (each scheduled chunk-slot costs ``block_size`` tokens). ``None``
        disables the split.
    ``min_prefill_chunks``
        Progress guarantee: at least this many chunk-slots run per tick
        while prefill is pending, even when the budget is below one chunk.
    ``share_window_ticks``
        Ticks in the sliding window behind ``phase_share()``.
    """

    prefill_token_budget: Optional[int] = None
    min_prefill_chunks: int = 1
    share_window_ticks: int = 32

    def __post_init__(self):
        if (self.prefill_token_budget is not None
                and self.prefill_token_budget < 1):
            raise ValueError("prefill_token_budget must be >= 1 or None")
        if self.min_prefill_chunks < 1:
            raise ValueError("min_prefill_chunks must be >= 1")
        if self.share_window_ticks < 1:
            raise ValueError("share_window_ticks must be >= 1")


class Scheduler:
    """Budgets each engine tick between chunked prefill and decode and
    keeps the per-phase accounting (tokens, seconds, tick share).

    One scheduler belongs to one engine, which drives it: ``chunk_quota``
    at the top of the prefill pass, ``note_phase`` after every program,
    ``end_tick`` when the tick closes.
    """

    def __init__(self, config: Optional[SchedulerConfig] = None):
        self.config = config or SchedulerConfig()
        #: lifetime token totals per phase
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.deferred_chunks = 0
        self._window = []          # (prefill_s, decode_s) per tick
        self._tick_s = {"prefill": 0.0, "decode": 0.0}

    def chunk_quota(self, block_size: int) -> Optional[int]:
        """Chunk-slots (``block_size`` tokens each) this tick may spend on
        prefill; ``None`` = unbounded (no phase split configured)."""
        budget = self.config.prefill_token_budget
        if budget is None:
            return None
        return max(self.config.min_prefill_chunks, budget // block_size)

    def note_deferred(self, chunks: int):
        if chunks > 0:
            self.deferred_chunks += chunks

    def tick_phase_seconds(self) -> dict:
        """The current tick's seconds per phase (before ``end_tick``)."""
        return dict(self._tick_s)

    def note_phase(self, phase: str, tokens: int, seconds: float):
        """One program ran: ``tokens`` scheduled positions in ``phase``
        took ``seconds`` (host clock around work that ends in a copy of
        its result to the host)."""
        if phase == "prefill":
            self.prefill_tokens += tokens
        else:
            self.decode_tokens += tokens
        self._tick_s[phase if phase in self._tick_s else "decode"] += \
            seconds

    def end_tick(self):
        """Close the tick: fold its phase seconds into the window."""
        cur = (self._tick_s["prefill"], self._tick_s["decode"])
        self._tick_s = {"prefill": 0.0, "decode": 0.0}
        if cur == (0.0, 0.0):
            return
        self._window.append(cur)
        if len(self._window) > self.config.share_window_ticks:
            self._window.pop(0)

    def phase_share(self) -> dict:
        """Each phase's share of the window's seconds (None when empty)."""
        p = sum(w[0] for w in self._window)
        d = sum(w[1] for w in self._window)
        total = p + d
        return {"prefill": (p / total) if total else None,
                "decode": (d / total) if total else None}
