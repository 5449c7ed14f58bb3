"""The thread-local amp state and the cast helper (counterpart of
``set_amp_state``/``restore_amp_state``/``_amp_cast_inputs`` in
``paddle_tpu/core/dispatch.py``).

The JAX package casts inside its op dispatcher. The port's Paddle-API
ops cast in ``core.dispatch.call`` as well; its torch-level functionals
(the GPT-2 and LLaMA models' and the fusion pass's) have no dispatcher,
so each that the JAX package dispatches under a name of either list
calls ``amp_cast(name, ...)`` on its inputs first. ``torch.autocast``
is not used: its lists are not Paddle's, they differ between CPU and
CUDA, and it does not cast an autograd Function's inputs. A cast is an
autograd op, so gradients come back in the inputs' own dtypes, as the
JAX package's cast folded into the differentiated function gives them.
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Optional

import torch

from ..core.dtype import convert_dtype
from .amp_lists import AMP_BLACK_OPS, AMP_WHITE_OPS

_FLOATS = (torch.float16, torch.bfloat16, torch.float32)


class AmpState(NamedTuple):
    """Level (O0, O1, O2, OD), amp dtype and the custom lists; hashable, so
    ``to_static`` keys its traces on it."""
    level: str = "O0"
    dtype: torch.dtype = torch.bfloat16
    custom_white: frozenset = frozenset()
    custom_black: frozenset = frozenset()


_tls = threading.local()


def amp_state() -> AmpState:
    return getattr(_tls, "state", AmpState())


def set_amp_state(level: str, dtype=None, custom_white=None,
                  custom_black=None) -> AmpState:
    """Set this thread's amp state; returns the previous one (for
    ``restore_amp_state``). ``dtype=None`` keeps the current amp dtype."""
    prev = amp_state()
    _tls.state = AmpState(
        level, prev.dtype if dtype is None else convert_dtype(dtype),
        frozenset(custom_white or ()), frozenset(custom_black or ()))
    return prev


def restore_amp_state(prev: AmpState) -> None:
    _tls.state = prev


@contextlib.contextmanager
def amp_state_as(state: AmpState):
    """Run a block under ``state`` (a recorded ``amp_state()``)."""
    prev = amp_state()
    _tls.state = state
    try:
        yield
    finally:
        _tls.state = prev


def cast_target(op_name: str) -> Optional[torch.dtype]:
    """The dtype an op's floating inputs go to under this thread's amp
    state, or None where they stay as they are. The black list wins over
    the white."""
    s = amp_state()
    if s.level not in ("O1", "O2"):
        return None
    name = op_name.lower()
    if name in AMP_BLACK_OPS or name in s.custom_black:
        return torch.float32
    if name in AMP_WHITE_OPS or name in s.custom_white:
        return s.dtype
    return None


def amp_cast(op_name: str, *tensors):
    """``tensors`` as op ``op_name`` takes them under the current amp
    state: fp16/bf16/fp32 tensors of another dtype than the target are
    cast; anything else (None, integer tensors) passes through."""
    target = cast_target(op_name)
    if target is None:
        return tensors
    return tuple(t.to(target) if isinstance(t, torch.Tensor)
                 and t.dtype in _FLOATS and t.dtype != target else t
                 for t in tensors)


__all__ = ["AmpState", "amp_state", "set_amp_state", "restore_amp_state",
           "amp_state_as", "cast_target", "amp_cast"]
