"""Distributed training (counterpart of ``paddle_tpu/distributed/``).
Ported so far: ``fleet.recompute``, block checkpointing on one card, and
the progress ``watchdog`` the serving engine attaches."""
from . import fleet, watchdog

__all__ = ["fleet", "watchdog"]
