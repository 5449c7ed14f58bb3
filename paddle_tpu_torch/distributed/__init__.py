"""Distributed training (counterpart of ``paddle_tpu/distributed/``).
Ported so far: ``fleet.recompute``, block checkpointing on one card."""
from . import fleet

__all__ = ["fleet"]
