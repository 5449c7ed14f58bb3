"""Activations (counterpart of ``paddle_tpu/nn/functional/activation.py``):
plain PyTorch, so that ``to_static``'s tracer records torch's own ops.
``softmax`` is on amp's black list and casts its input for it.

On a Paddle ``Tensor`` each is one op through ``core.dispatch.call``
(the JAX package's op name), with the same math; on a ``torch.Tensor``
it is the torch-level function."""
from __future__ import annotations

import sys
from typing import Optional

import torch
from torch.nn import functional as TF

from ...amp.state import amp_cast
from ...core import dispatch
from ...core.dtype import convert_dtype
from ...core.tensor import Tensor
from ...ops.registry import register_module


def gelu(x, approximate: bool = False, name=None):
    """Exact (erf) gelu, or the tanh approximation with ``approximate``."""
    if isinstance(x, Tensor):
        return dispatch.call("gelu", lambda a, **_: gelu(a, approximate),
                             [x], attrs={"approximate": bool(approximate)})
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def silu(x, name=None):
    if isinstance(x, Tensor):
        return dispatch.call("silu", TF.silu, [x])
    return TF.silu(x)


def relu(x, name=None):
    if isinstance(x, Tensor):
        return dispatch.call("relu", TF.relu, [x])
    return TF.relu(x)


def relu6(x, name=None):
    """min(max(x, 0), 6)."""
    if isinstance(x, Tensor):
        return dispatch.call("relu6", relu6, [x])
    return torch.clamp(x, 0, 6)


#: the JAX package's alias: swish is silu, one op under silu's name
swish = silu


def hardswish(x, name=None):
    """x * relu6(x + 3) / 6."""
    if isinstance(x, Tensor):
        return dispatch.call("hardswish", hardswish, [x])
    return x * torch.clamp(x + 3, 0, 6) / 6


def hardsigmoid(x, slope: float = 1.0 / 6, offset: float = 0.5, name=None):
    """clip(slope * x + offset, 0, 1)."""
    if isinstance(x, Tensor):
        return dispatch.call("hardsigmoid",
                             lambda a: hardsigmoid(a, slope, offset), [x])
    return torch.clamp(slope * x + offset, 0, 1)


def tanh(x, name=None):
    if isinstance(x, Tensor):
        return dispatch.call("tanh", torch.tanh, [x])
    return torch.tanh(x)


def sigmoid(x, name=None):
    if isinstance(x, Tensor):
        return dispatch.call("sigmoid", torch.sigmoid, [x])
    return torch.sigmoid(x)


def softmax(x, axis: int = -1, dtype=None, name=None):
    """softmax over ``axis``; ``dtype`` casts the input first."""
    if isinstance(x, Tensor):
        return dispatch.call("softmax", lambda a: softmax(a, axis, dtype),
                             [x], export_attrs=lambda: {"axis": axis})
    (x,) = amp_cast("softmax", x)
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    return TF.softmax(x, dim=axis)


def swiglu(x: torch.Tensor, y: Optional[torch.Tensor] = None,
           name=None) -> torch.Tensor:
    """silu(x) * y; with one argument, x is split in half on the last dim.
    One op to the fusion pass, as in the JAX package (no pattern takes it)."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return TF.silu(x) * y


__all__ = ["gelu", "silu", "relu", "relu6", "swish", "hardswish",
           "hardsigmoid", "tanh", "sigmoid", "softmax", "swiglu"]

register_module(sys.modules[__name__], "activation", skip=("sigmoid", "tanh"))
