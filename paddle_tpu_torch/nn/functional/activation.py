"""Activations (counterpart of ``paddle_tpu/nn/functional/activation.py``):
plain PyTorch, so that ``to_static``'s tracer records torch's own ops.
``rrelu`` (training) and ``gumbel_softmax`` draw from a
``torch.Generator``: the caller's, else the device's Paddle-API one.
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
from ...core.generator import default_generator
from ...core.tensor import Tensor, _payload
from ...ops.registry import register_module
from ._op import call


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
    if isinstance(x, Tensor):
        return dispatch.call("swiglu", swiglu, [x] if y is None else [
            x, y if isinstance(y, Tensor) else Tensor(_payload(y))])
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return TF.silu(x) * y


def _unary(op_name, body, doc):
    def op(x, name=None):
        return call(op_name, body, [x])
    op.__name__ = op.__qualname__ = op_name
    op.__doc__ = doc
    return op


mish = _unary("mish", lambda a: a * torch.tanh(TF.softplus(a)),
              "x * tanh(softplus(x)).")
softsign = _unary("softsign", lambda a: a / (1 + a.abs()), "x / (1 + |x|).")
tanhshrink = _unary("tanhshrink", lambda a: a - torch.tanh(a),
                    "x - tanh(x).")
log_sigmoid = _unary("log_sigmoid", TF.logsigmoid,
                     "log(sigmoid(x)), computed stably.")


def _where(cond, a, value):
    """a where cond, else the scalar or tensor ``value``."""
    if not isinstance(value, torch.Tensor):
        value = torch.as_tensor(value, dtype=a.dtype, device=a.device)
    return torch.where(cond, a, value)


def leaky_relu(x, negative_slope=0.01, name=None):
    """x if x >= 0 else negative_slope * x."""
    return call("leaky_relu",
                lambda a: torch.where(a >= 0, a, negative_slope * a), [x])


def elu(x, alpha=1.0, name=None):
    """x if x > 0 else alpha * (exp(x) - 1)."""
    return call("elu", lambda a: torch.where(a > 0, a, alpha * torch.expm1(a)),
                [x])


def celu(x, alpha=1.0, name=None):
    """x if x > 0 else alpha * (exp(x / alpha) - 1)."""
    return call("celu", lambda a: torch.where(
        a > 0, a, alpha * torch.expm1(a / alpha)), [x])


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    """scale * (x if x > 0 else alpha * (exp(x) - 1))."""
    return call("selu", lambda a: scale * torch.where(
        a > 0, a, alpha * torch.expm1(a)), [x])


def hardtanh(x, min=-1.0, max=1.0, name=None):
    """x clipped to [min, max]."""
    return call("hardtanh", lambda a: torch.clamp(a, min, max), [x])


def hardshrink(x, threshold=0.5, name=None):
    """x where |x| > threshold, else 0."""
    return call("hardshrink",
                lambda a: _where(a.abs() > threshold, a, 0.0), [x])


def softshrink(x, threshold=0.5, name=None):
    """x shrunk toward 0 by ``threshold``; 0 inside the band."""
    def body(a):
        zero = torch.zeros((), dtype=a.dtype, device=a.device)
        return torch.where(a > threshold, a - threshold, torch.where(
            a < -threshold, a + threshold, zero))
    return call("softshrink", body, [x])


def softplus(x, beta=1.0, threshold=20.0, name=None):
    """log(1 + exp(beta x)) / beta, x itself where beta x > threshold."""
    def body(a):
        scaled = beta * a
        return torch.where(scaled > threshold, a,
                           torch.logaddexp(scaled, torch.zeros_like(scaled))
                           / beta)
    return call("softplus", body, [x])


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    """x where x > threshold, else ``value``."""
    return call("thresholded_relu",
                lambda a: _where(a > threshold, a, value), [x])


def prelu(x, weight, data_format="NCHW", name=None):
    """Leaky relu with the learned slope ``weight``: one value, or one a
    channel (axis 1, or the last axis for a channel-last format)."""
    def body(a, w):
        if w.numel() == 1:
            wb = w.reshape(())
        else:
            shape = [1] * a.dim()
            ch = 1 if data_format in ("NCHW", "NCL", "NCDHW") else a.dim() - 1
            shape[ch] = w.numel()
            wb = w.reshape(shape)
        return torch.where(a >= 0, a, wb * a)
    return call("prelu", body, [x, weight])


def _generator(x, generator):
    return generator or default_generator(_payload(x).device)


def rrelu(x, lower=0.125, upper=1.0 / 3, training=False, name=None,
          generator: Optional[torch.Generator] = None):
    """Leaky relu whose slope is drawn from U[lower, upper) per element
    while training (from ``generator``, else the device's Paddle-API
    generator), and (lower + upper) / 2 otherwise."""
    if training:
        g = _generator(x, generator)

        def body(a):
            slope = torch.rand(a.shape, generator=g, device=a.device,
                               dtype=torch.float32).to(a.dtype)
            return torch.where(a >= 0, a, (lower + (upper - lower) * slope)
                               * a)
    else:
        mid = (lower + upper) / 2

        def body(a):
            return torch.where(a >= 0, a, mid * a)
    return call("rrelu", body, [x])


def log_softmax(x, axis=-1, dtype=None, name=None):
    """x - logsumexp(x) over ``axis``; ``dtype`` casts the input first."""
    def body(a):
        if dtype is not None:
            a = a.to(convert_dtype(dtype))
        return torch.log_softmax(a, dim=axis)
    return call("log_softmax", body, [x])


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None,
                   generator: Optional[torch.Generator] = None):
    """softmax((x + g) / temperature) with Gumbel noise g; ``hard`` gives
    the one-hot of the argmax in the forward and the soft gradient."""
    g = _generator(x, generator)

    def body(a):
        u = torch.rand(a.shape, generator=g, device=a.device,
                       dtype=torch.float32).clamp_min(
                           torch.finfo(torch.float32).tiny)
        y = torch.softmax((a + (-torch.log(-torch.log(u))).to(a.dtype))
                          / temperature, dim=axis)
        if hard:
            idx = y.argmax(dim=axis, keepdim=True)
            y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
            y = (y_hard - y).detach() + y
        return y
    return call("gumbel_softmax", body, [x])


def maxout(x, groups, axis=1, name=None):
    """Max over ``groups`` consecutive channels of ``axis``."""
    def body(a):
        ax = axis % a.dim()
        shape = list(a.shape)
        new = shape[:ax] + [shape[ax] // groups, groups] + shape[ax + 1:]
        return a.reshape(new).amax(dim=ax + 1)
    return call("maxout", body, [x])


def glu(x, axis=-1, name=None):
    """a * sigmoid(b) over the two halves of ``axis``."""
    def body(a):
        a1, a2 = a.chunk(2, dim=axis)
        return a1 * torch.sigmoid(a2)
    return call("glu", body, [x])


__all__ = ["gelu", "silu", "relu", "relu6", "swish", "hardswish",
           "hardsigmoid", "tanh", "sigmoid", "softmax", "swiglu", "mish",
           "softsign", "tanhshrink", "log_sigmoid", "leaky_relu", "elu",
           "celu", "selu", "hardtanh", "hardshrink", "softshrink",
           "softplus", "prelu", "rrelu", "log_softmax", "gumbel_softmax",
           "maxout", "glu", "thresholded_relu"]

register_module(sys.modules[__name__], "activation", skip=("sigmoid", "tanh"))
