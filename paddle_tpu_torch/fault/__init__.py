"""The reliability layer of the PyTorch port (counterpart of
``paddle_tpu/fault``):

- **Atomic and verified checkpoints**: ``framework.io`` saves through a
  temp file, fsync and rename with a checksummed v2 footer;
  :class:`CheckpointManager` adds rotation (``keep_n``), a manifest of
  completed saves, and ``restore()`` that falls back past a corrupt or
  partial checkpoint to the last verifiable one; ``auto_resume`` puts
  the newest verifiable train state back into a model and optimizer.
- **Retry and backoff**: :func:`retry` with exponential backoff, jitter
  and a deadline, used by the checkpoint writes; exhaustion re-raises
  the original error.
- **Deterministic fault injection**: :mod:`.inject` names failure points
  that production code guards at near-zero cost and tests arm to prove
  each recovery path.
- :mod:`.supervisor`: the training loop's supervisor seam (``tick``).

``CheckpointManager`` and the train-state helpers resolve lazily because
they sit above ``framework.io``, which itself guards its writes with
:mod:`.inject` (the package must be importable from below).
"""
from __future__ import annotations

import importlib

from . import inject, supervisor
from .inject import InjectedFault
from .retry import RetryPolicy, retry

__all__ = ["inject", "supervisor", "InjectedFault", "RetryPolicy", "retry",
           "CheckpointManager", "auto_resume", "capture_train_state",
           "restore_train_state"]

_LAZY = {"CheckpointManager", "auto_resume", "capture_train_state",
         "restore_train_state"}


def __getattr__(name):
    if name in _LAZY:
        mod = importlib.import_module(".checkpoint_manager", __name__)
        for n in _LAZY:
            globals()[n] = getattr(mod, n)
        return globals()[name]
    raise AttributeError(
        f"module 'paddle_tpu_torch.fault' has no attribute {name!r}")
