"""Fault injection of the PyTorch port (counterpart of
``paddle_tpu/fault``): :mod:`.inject` names failure points that the
serving engine guards at near-zero cost and tests arm to prove its
recovery paths; :mod:`.supervisor` holds the training loop's
supervisor seam."""
from __future__ import annotations

from . import inject, supervisor
from .inject import InjectedFault

__all__ = ["inject", "supervisor", "InjectedFault"]
