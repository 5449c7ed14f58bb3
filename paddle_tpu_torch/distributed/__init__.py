"""Distributed training (counterpart of ``paddle_tpu/distributed/``).
Ported so far: ``fleet.recompute``, block checkpointing on one card, and
the progress ``watchdog`` the serving engine attaches, and the rank and
world size from the launcher's environment (``RANK``/``WORLD_SIZE`` or
Paddle's ``PADDLE_TRAINER_ID``/``PADDLE_TRAINERS_NUM``)."""
from . import fleet, watchdog
from ..observability.reqtrace import rank_world


def get_rank() -> int:
    return rank_world()[0]


def get_world_size() -> int:
    return rank_world()[1]


__all__ = ["fleet", "watchdog", "get_rank", "get_world_size"]
