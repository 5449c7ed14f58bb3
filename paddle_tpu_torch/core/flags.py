"""Runtime flags (counterpart of ``paddle_tpu/core/flags.py``).

Only the flags the port reads are defined. Names may carry the ``FLAGS_``
prefix, as in the JAX package, and an environment variable ``FLAGS_<name>``
overrides a flag's default when the flag is defined.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict

_lock = threading.Lock()
_values: Dict[str, Any] = {}
_types: Dict[str, type] = {}


def _key(name: str) -> str:
    return name[6:] if name.startswith("FLAGS_") else name


def _coerce(ty: type, value):
    if ty is bool and isinstance(value, str):
        return value.strip().lower() in ("1", "true", "yes", "on")
    return ty(value)


def define_flag(name: str, default):
    """Register a flag; ``FLAGS_<name>`` in the environment overrides the
    default. Returns the flag's value."""
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


# rewrite matched subgraphs (norm->linear->act, residual+norm, bias+act,
# rope+projection) onto the fused ops in to_static
define_flag("enable_fusion", False)
