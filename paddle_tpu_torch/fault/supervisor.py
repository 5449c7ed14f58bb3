"""The training loop's supervisor seam (counterpart of ``get``, ``tick``
and ``register_scaler`` in ``paddle_tpu/fault/supervisor.py``).

``hapi.Model.fit`` calls ``tick(step)`` once a step; it forwards the tick
to the process's active supervisor, one dict lookup when none runs. The
``Supervisor`` process plane (leases, the collective-timeout abort,
consensus rewind, remediation) is still to port, so no supervisor is
ever active yet; ``_default`` is where a started one will register.
"""
from __future__ import annotations

from typing import Dict, Optional

__all__ = ["get", "tick", "register_scaler"]

_default: Dict[str, Optional[object]] = {"s": None}
_scaler_ref: Dict[str, Optional[object]] = {"s": None}


def get():
    """The process's active supervisor (the last one started), if any."""
    return _default["s"]


def tick(step: Optional[int] = None):
    """Training-loop seam: forward one step tick to the active
    supervisor. One dict lookup when none is running."""
    s = _default["s"]
    if s is not None:
        s.beat(step)


def register_scaler(scaler):
    """Hand the remediation engine the run's GradScaler (the hapi fit
    path registers the one its ModelCheckpoint callback carries)."""
    _scaler_ref["s"] = scaler
