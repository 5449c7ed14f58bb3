"""Runtime flags (counterpart of ``paddle_tpu/core/flags.py``).

Only the flags the port reads are defined. Names may carry the ``FLAGS_``
prefix, as in the JAX package, and an environment variable ``FLAGS_<name>``
overrides a flag's default when the flag is defined. ``on_change``
subscribes to a flag: the hot paths (metrics, request tracing) keep a
mirror of their flag in a dict that ``set_flags`` updates.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, List

_lock = threading.Lock()
_values: Dict[str, Any] = {}
_types: Dict[str, type] = {}
_observers: Dict[str, List[Callable[[Any], None]]] = {}


def _key(name: str) -> str:
    return name[6:] if name.startswith("FLAGS_") else name


def _coerce(ty: type, value):
    if ty is bool and isinstance(value, str):
        return value.strip().lower() in ("1", "true", "yes", "on")
    return ty(value)


def define_flag(name: str, default, help: str = ""):
    """Register a flag; ``FLAGS_<name>`` in the environment overrides the
    default. Returns the flag's value. ``help`` documents it where it is
    defined, as in the JAX package."""
    with _lock:
        if name not in _values:
            ty = type(default)
            env = os.environ.get("FLAGS_" + name)
            _types[name] = ty
            _values[name] = _coerce(ty, env) if env is not None else default
        return _values[name]


def get_flag(name: str):
    key = _key(name)
    if key not in _values:
        raise KeyError(f"Flag {name!r} is not defined")
    return _values[key]


def set_flags(flags: Dict[str, Any]) -> None:
    """Set flags by name (``"FLAGS_enable_fusion"`` or ``"enable_fusion"``)."""
    with _lock:
        for name, value in flags.items():
            key = _key(name)
            if key not in _values:
                raise KeyError(f"Flag {name!r} is not defined")
            _values[key] = _coerce(_types[key], value)
            for fn in _observers.get(key, ()):
                fn(_values[key])


def on_change(name: str, fn: Callable[[Any], None]) -> None:
    """Call ``fn(value)`` after every ``set_flags`` of ``name``."""
    _observers.setdefault(_key(name), []).append(fn)


# rewrite matched subgraphs (norm->linear->act, residual+norm, bias+act,
# rope+projection) onto the fused ops in to_static
define_flag("enable_fusion", False)

# io/prefetch.py: hapi Model.fit wraps its loader in a DevicePrefetcher
define_flag("prefetch", True,
            "Double-buffered device prefetch in hapi.Model.fit: the next "
            "batch's host fetch and copy to the card run on a background "
            "thread while the current step computes (io.DevicePrefetcher).")
define_flag("prefetch_depth", 2,
            "Batches the DevicePrefetcher keeps in flight ahead of the "
            "consumer (>=1; 2 = double buffering).")
