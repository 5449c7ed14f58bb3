"""Per-request statuses (counterpart of part of ``paddle_tpu/inference/resilience.py``).

Only the status constants are ported in this slice; the replica
lifecycle, ``Overloaded`` backpressure, deadlines and metrics come later.
"""
from __future__ import annotations


class RequestStatus:
    """String constants for the per-request state machine:
    ``QUEUED -> RUNNING -> FINISHED``, or FAILED for a request that can
    never fit the engine's geometry. A request may bounce
    ``RUNNING -> QUEUED`` under recompute preemption."""

    QUEUED = "QUEUED"
    RUNNING = "RUNNING"
    FINISHED = "FINISHED"
    SHED = "SHED"
    DEADLINE_MISSED = "DEADLINE_MISSED"
    CANCELLED = "CANCELLED"
    FAILED = "FAILED"
