"""The training loop's supervisor seam and the watchdog's exit codes
(counterpart of ``get``, ``tick``, ``register_scaler``,
``EXIT_DESYNC``/``EXIT_WATCHDOG_HANG``, ``describe_exit`` and
``force_exit`` in ``paddle_tpu/fault/supervisor.py``).

The exit codes tell an elastic agent why a worker died: the watchdog's
``abort_on_hang`` ends the process with ``EXIT_DESYNC`` when the
cross-rank flight diff named a desynced rank, else
``EXIT_WATCHDOG_HANG``; ``force_exit`` persists the flight ring and the
goodput ledger first (``os._exit`` skips atexit).

``hapi.Model.fit`` calls ``tick(step)`` once a step; it forwards the tick
to the process's active supervisor, one dict lookup when none runs. The
``Supervisor`` process plane (leases, the collective-timeout abort,
consensus rewind, remediation) is still to port, so no supervisor is
ever active yet; ``_default`` is where a started one will register.
"""
from __future__ import annotations

import os
import signal
import sys
from typing import Dict, Optional

__all__ = ["get", "tick", "register_scaler", "EXIT_DESYNC",
           "EXIT_WATCHDOG_HANG", "EXIT_CODES", "describe_exit", "force_exit"]

# --------------------------------------------------------------- exit codes
EXIT_DESYNC = 119
EXIT_WATCHDOG_HANG = 120

#: code -> (name, restart_worthy, description)
EXIT_CODES: Dict[int, tuple] = {
    EXIT_DESYNC: (
        "DESYNC", True,
        "cross-rank flight diff named a desynced rank"),
    EXIT_WATCHDOG_HANG: (
        "WATCHDOG_HANG", True,
        "progress watchdog fired without a cross-rank desync verdict"),
}


def describe_exit(code: Optional[int]) -> str:
    """A worker exit code's name (signal deaths are the negative codes
    ``subprocess`` reports)."""
    if code is None:
        return "running"
    if code in EXIT_CODES:
        name, _, desc = EXIT_CODES[code]
        return f"{name} ({desc})"
    if code < 0:
        try:
            return f"signal {signal.Signals(-code).name}"
        except ValueError:
            return f"signal {-code}"
    return f"exit {code}"


#: replaceable exit hook, so an in-process test can observe force_exit
#: without dying (the real path is os._exit: an atexit handler may touch
#: the wedged communicator and hang the abort itself)
_exit = {"fn": os._exit}


def force_exit(code: int, reason: str = ""):
    """Terminal abort: persist the flight ring and the goodput ledger
    (``os._exit`` skips atexit), flush, and exit with ``code``."""
    try:
        sys.stderr.write(f"[supervisor] force exit code={code} "
                         f"({describe_exit(code)}): {reason}\n")
    except Exception:
        pass
    try:
        from ..observability import flight as _flight
        _flight.dump(reason=f"force_exit {code}: {reason}")
    except Exception:
        pass
    try:
        from ..observability import goodput as _goodput
        _goodput.dump(reason=f"force_exit {code}: {reason}")
    except Exception:
        pass
    try:
        sys.stdout.flush()
        sys.stderr.flush()
    except Exception:
        pass
    _exit["fn"](code)


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
