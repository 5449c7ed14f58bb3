"""Deterministic fault injection: named failure points for recovery tests
(counterpart of ``paddle_tpu/fault/inject.py``).

The registry is the JAX package's, with its whole table of points, so a
drill that arms a point by name arms it the same way in either package
(each package has its own registry). In the port the ``serving.*``
points are wired (``serving.tick_stall`` and ``serving.crash_at_tick``
in the engine's tick, ``serving.admission_oom`` in its admission), and
``collective.desync`` in ``distributed/communication/collective.py``.

Production code guards a risky operation with ``inject.check("name")`` (or
reads parameters via ``inject.peek``); when nothing is armed the guard is
one module-dict truthiness test, so the cost in real runs is effectively
zero. Tests arm a point for a bounded number of shots and prove the
recovery path end-to-end — crash-mid-save leaves the old checkpoint
intact, resume skips a corrupt latest, retry exhaustion surfaces the
original error — without monkeypatching internals or sleeping.

Every point is deterministic: it fires on the first ``times`` matching
calls and never again, and arming an unknown name is an error (typo
guard). The registered points:

==================================  =========================================
``io.write_truncate_after_bytes``   checkpoint writer stops mid-file after
                                    ``after_bytes`` bytes (simulated crash /
                                    full disk); params: ``after_bytes``
``io.rename_fail``                  the atomic ``os.replace`` publish step
                                    raises ``OSError``
``io.fsync_fail``                   the pre-publish fsync raises ``OSError``
``collective.timeout``              host-side object collectives raise
                                    ``TimeoutError`` (stuck peer)
``grads.nan_at_step``               the training loop poisons the loss with
                                    NaN at global step ``step``
``pcc.write_truncate_after_bytes``  the compilation-cache entry writer stops
                                    mid-file after ``after_bytes`` bytes
                                    (torn cache publish); params:
                                    ``after_bytes``
``serving.tick_stall``              the serving engine tick blocks for
                                    ``seconds`` before doing any work (a
                                    wedged device transfer / compile) —
                                    exercises the watchdog → DEGRADED path;
                                    params: ``seconds``
``serving.admission_oom``           admission-time block allocation is forced
                                    to fail as if another slot raced it to
                                    the last KV blocks — exercises the
                                    requeue-not-raise path
``serving.crash_at_tick``           an unexpected exception is raised inside
                                    the engine tick whose ordinal equals
                                    ``tick`` — exercises the fail-in-flight
                                    + degrade + keep-serving path; params:
                                    ``tick``
``fleet.slow_step``                 the fleet beacon sleeps ``seconds``
                                    inside each observed training step —
                                    the deterministic slow-rank drill for
                                    straggler detection (arm on ONE rank);
                                    params: ``seconds``
``collective.desync``               a shape-preserving tensor collective
                                    (``all_reduce`` / ``all_gather`` /
                                    ``broadcast`` / ``barrier``) is BYPASSED
                                    on this rank (peers block on the missing
                                    participant) — the deterministic desync
                                    drill for the flight-recorder diff;
                                    params: optional ``op`` filter. Other
                                    primitives change output shape under a
                                    bypass and are not wired.
``rank.crash_at_step``              the supervisor heartbeat kills this
                                    process with SIGKILL (no atexit, no
                                    dump — a real machine death) at global
                                    step ``step``; params: ``step``
``rank.hang_at_step``               the supervisor heartbeat wedges this
                                    rank in an uninterruptible sleep at
                                    global step ``step`` (peers block in the
                                    next collective) — the deterministic
                                    hang drill for the collective-timeout
                                    abort plane; params: ``step``
``heartbeat.lease_lost``            the supervisor stops publishing this
                                    rank's heartbeat lease (process stays
                                    alive — a network partition, not a
                                    death) so peers observe lease expiry;
                                    params: optional ``step``
==================================  =========================================
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

__all__ = ["InjectedFault", "POINTS", "arm", "disarm", "disarm_all",
           "is_armed", "fired_count", "peek", "fire", "check", "armed"]


class InjectedFault(Exception):
    """Raised by a firing fault point (unless the guard maps it to a more
    faithful exception type, e.g. OSError for filesystem points)."""

    def __init__(self, point: str, message: str = ""):
        self.point = point
        super().__init__(message or f"injected fault at {point!r}")


#: the full set of known failure points — arming anything else is an error
POINTS = frozenset({
    "io.write_truncate_after_bytes",
    "io.rename_fail",
    "io.fsync_fail",
    "collective.timeout",
    "grads.nan_at_step",
    "pcc.write_truncate_after_bytes",
    "serving.tick_stall",
    "serving.admission_oom",
    "serving.crash_at_tick",
    "fleet.slow_step",
    "collective.desync",
    "rank.crash_at_step",
    "rank.hang_at_step",
    "heartbeat.lease_lost",
})

_lock = threading.Lock()
# name -> {"times": shots to fire, "fired": shots consumed, "params": {...}}
# The dict is EMPTY whenever nothing is armed, so production guards bail on
# a single truthiness check.
_armed: Dict[str, dict] = {}


def arm(name: str, times: int = 1, **params) -> None:
    """Arm ``name`` to fire on its next ``times`` matching calls."""
    if name not in POINTS:
        raise ValueError(
            f"unknown fault point {name!r}; registered points: "
            f"{sorted(POINTS)}")
    if times < 1:
        raise ValueError(f"times must be >= 1, got {times}")
    with _lock:
        _armed[name] = {"times": int(times), "fired": 0,
                        "params": dict(params)}


def disarm(name: str) -> None:
    with _lock:
        _armed.pop(name, None)


def disarm_all() -> None:
    with _lock:
        _armed.clear()


def is_armed(name: str) -> bool:
    spec = _armed.get(name)
    return bool(spec and spec["fired"] < spec["times"])


def fired_count(name: str) -> int:
    spec = _armed.get(name)
    return spec["fired"] if spec else 0


def peek(name: str, **ctx) -> Optional[dict]:
    """Params of an armed point with shots remaining, WITHOUT consuming a
    shot (for guards that need the parameters up front, e.g. the truncating
    writer reads ``after_bytes`` before any byte is written). Returns None
    when disarmed, out of shots, or the armed params mismatch ``ctx``."""
    if not _armed:
        return None
    spec = _armed.get(name)
    if spec is None or spec["fired"] >= spec["times"]:
        return None
    if not _ctx_matches(spec["params"], ctx):
        return None
    return dict(spec["params"])


def fire(name: str, **ctx) -> Optional[dict]:
    """Consume one shot if ``name`` is armed and its params match ``ctx``
    (every armed param also present in ``ctx`` must compare equal — so
    ``arm("grads.nan_at_step", step=3)`` fires only on the call whose
    ``step=3``). Returns the params dict when the point fires."""
    if not _armed:
        return None
    with _lock:
        spec = _armed.get(name)
        if spec is None or spec["fired"] >= spec["times"]:
            return None
        if not _ctx_matches(spec["params"], ctx):
            return None
        spec["fired"] += 1
        return dict(spec["params"])


def _ctx_matches(params: dict, ctx: dict) -> bool:
    for k, v in params.items():
        if k in ctx and ctx[k] != v:
            return False
    return True


def check(name: str, exc=None, **ctx) -> bool:
    """Production guard: raise when the point fires, else return False.
    ``exc`` maps the injected failure onto the exception type real code
    would see at that site (OSError for filesystem, TimeoutError for a
    stuck collective); default is :class:`InjectedFault`."""
    params = fire(name, **ctx)
    if params is None:
        return False
    if exc is None or (isinstance(exc, type)
                       and issubclass(exc, InjectedFault)):
        raise InjectedFault(name)
    raise exc(f"injected fault at {name!r}")


@contextlib.contextmanager
def armed(name: str, times: int = 1, **params):
    """Scoped arm for tests: disarms on exit even if the body raises."""
    arm(name, times=times, **params)
    try:
        yield
    finally:
        disarm(name)
