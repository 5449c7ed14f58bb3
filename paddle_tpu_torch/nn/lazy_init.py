"""LazyGuard: deferred parameter initialization (counterpart of
``paddle_tpu/nn/lazy_init.py``).

Inside the guard a new parameter's payload is a tensor on torch's
``meta`` device (its shape and dtype read, no storage, no compute) and
its initializer is recorded. A layer's first call materializes every
pending parameter under it, on the current device; ``materialize_layer``
does it explicitly.
"""
from __future__ import annotations

import weakref

__all__ = ["LazyGuard", "in_lazy_mode", "materialize_layer",
           "materialize_parameter"]

_STATE = {"on": False}
# pending parameters by id, as weak references (a Tensor compares
# elementwise, so no WeakSet): an abandoned model stops counting
_PENDING: dict = {}


class LazyGuard:
    """Context manager: defer parameter initialization inside."""

    def __enter__(self):
        _STATE["on"] = True
        return self

    def __exit__(self, *exc):
        _STATE["on"] = False
        return False


def in_lazy_mode() -> bool:
    return _STATE["on"]


def _register(param, init, shape, dtype) -> None:
    param._lazy_init = (init, tuple(shape), dtype)
    key = id(param)
    _PENDING[key] = weakref.ref(
        param, lambda _ref, _k=key: _PENDING.pop(_k, None))


def has_outstanding() -> bool:
    return bool(_PENDING)


def materialize_parameter(param) -> bool:
    """Run the recorded initializer; True if this call materialized."""
    lazy = getattr(param, "_lazy_init", None)
    if lazy is None:
        return False
    init, shape, dtype = lazy
    data = init(shape, dtype).detach()
    data.requires_grad_(param._data.requires_grad)
    param._swap_payload(data)
    del param._lazy_init
    _PENDING.pop(id(param), None)
    return True


def materialize_layer(layer) -> int:
    """Materialize every lazy parameter under ``layer``; returns how
    many."""
    return sum(materialize_parameter(p) for p in layer.parameters()
               if p is not None)
