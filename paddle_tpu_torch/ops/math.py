"""Elementwise math, comparison and logic ops (counterpart of
``paddle_tpu/ops/math.py``): each a plain torch body behind
``dispatch.call``.

A Python scalar operand becomes a 0-d tensor, which torch's promotion
treats as the JAX package's weak types do: ``int32 + 2.5`` is float32,
``bf16 * 2.0`` stays bf16.
"""
from __future__ import annotations

import torch

from ..core import dispatch
from ..core.dtype import convert_dtype
from ..core.tensor import Tensor, as_tensor
from .registry import register

__all__ = []


def _export(fn):
    __all__.append(fn.__name__)
    return fn


def _t(x):
    return x if isinstance(x, Tensor) else as_tensor(x)


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    # a fill, not a host-to-device copy: no sync on the card
    return torch.full((), v, device=like.device)


def _binary(name, tfn, x, y):
    xt, yt = isinstance(x, Tensor), isinstance(y, Tensor)
    if xt and yt:
        return dispatch.call(name, tfn, [x, y])
    if xt:
        return dispatch.call(name, lambda a: tfn(a, _scalar(y, a)), [x])
    if yt:
        return dispatch.call(name, lambda b: tfn(_scalar(x, b), b), [y])
    return dispatch.call(name, tfn, [_t(x), _t(y)])


def _make_binary(name, tfn, aliases=()):
    def op(x, y, name_=None):
        return _binary(name, tfn, x, y)
    op.__name__ = op.__qualname__ = name
    op.__doc__ = f"Elementwise ``{name}(x, y)`` with broadcasting."
    register(name, category="math")(op)
    _export(op)
    g = globals()
    g[name] = op
    for a in aliases:
        g[a] = op
        __all__.append(a)
    return op


def _make_unary(name, tfn, aliases=(), differentiable=True):
    def op(x, name_=None):
        return dispatch.call(name, tfn, [_t(x)])
    op.__name__ = op.__qualname__ = name
    op.__doc__ = f"Elementwise ``{name}(x)``."
    register(name, category="math", differentiable=differentiable)(op)
    _export(op)
    g = globals()
    g[name] = op
    for a in aliases:
        g[a] = op
        __all__.append(a)
    return op


# -------------------------------------------------------------------- binary
_make_binary("add", torch.add)
_make_binary("subtract", torch.sub)
_make_binary("multiply", torch.mul)
_make_binary("divide", torch.true_divide)
_make_binary("floor_divide", torch.floor_divide)
_make_binary("mod", torch.remainder, aliases=("remainder", "floor_mod"))
_make_binary("pow", torch.pow)
_make_binary("maximum", torch.maximum)
_make_binary("minimum", torch.minimum)
_make_binary("fmax", torch.fmax)
_make_binary("fmin", torch.fmin)
_make_binary("atan2", torch.atan2)
_make_binary("hypot", torch.hypot)
_make_binary("logaddexp", torch.logaddexp)

_make_binary("equal", torch.eq)
_make_binary("not_equal", torch.ne)
_make_binary("less_than", torch.lt, aliases=("less",))
_make_binary("less_equal", torch.le)
_make_binary("greater_than", torch.gt, aliases=("greater",))
_make_binary("greater_equal", torch.ge)

_make_binary("logical_and", torch.logical_and)
_make_binary("logical_or", torch.logical_or)
_make_binary("logical_xor", torch.logical_xor)
_make_binary("bitwise_and", torch.bitwise_and)
_make_binary("bitwise_or", torch.bitwise_or)
_make_binary("bitwise_xor", torch.bitwise_xor)

# --------------------------------------------------------------------- unary
_make_unary("exp", torch.exp)
_make_unary("expm1", torch.expm1)
_make_unary("log", torch.log)
_make_unary("log2", torch.log2)
_make_unary("log10", torch.log10)
_make_unary("log1p", torch.log1p)
_make_unary("sqrt", torch.sqrt)
_make_unary("rsqrt", torch.rsqrt)
_make_unary("square", torch.square)
_make_unary("abs", torch.abs)
_make_unary("neg", torch.neg)
_make_unary("sign", torch.sign)
_make_unary("floor", torch.floor)
_make_unary("ceil", torch.ceil)
_make_unary("round", torch.round)
_make_unary("trunc", torch.trunc)
_make_unary("reciprocal", torch.reciprocal)
_make_unary("sin", torch.sin)
_make_unary("cos", torch.cos)
_make_unary("tan", torch.tan)
_make_unary("asin", torch.asin)
_make_unary("acos", torch.acos)
_make_unary("atan", torch.atan)
_make_unary("sinh", torch.sinh)
_make_unary("cosh", torch.cosh)
_make_unary("tanh", torch.tanh)
_make_unary("erf", torch.erf)
_make_unary("erfinv", torch.erfinv)
_make_unary("sigmoid", torch.sigmoid)
_make_unary("logical_not", torch.logical_not, differentiable=False)
_make_unary("bitwise_not", torch.bitwise_not, differentiable=False)
_make_unary("isnan", torch.isnan, differentiable=False)
_make_unary("isinf", torch.isinf, differentiable=False)
_make_unary("isfinite", torch.isfinite, differentiable=False)


@register("scale", category="math")
@_export
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """x * scale + bias (or (x + bias) * scale); an integer x keeps its
    dtype."""
    def f(a, *s):
        k = s[0] if s else scale
        out = a * k + bias if bias_after_scale else (a + bias) * k
        return out if a.is_floating_point() or s else out.to(a.dtype)
    if isinstance(scale, Tensor):
        return dispatch.call("scale", f, [_t(x), scale])
    return dispatch.call("scale", f, [_t(x)])


@register("clip", category="math")
@_export
def clip(x, min=None, max=None, name=None):
    """Clamp to [min, max]; the bounds may be Tensors."""
    if isinstance(min, Tensor) or isinstance(max, Tensor):
        lo = min if isinstance(min, Tensor) else _t(
            min if min is not None else -float("inf"))
        hi = max if isinstance(max, Tensor) else _t(
            max if max is not None else float("inf"))
        return dispatch.call("clip", lambda a, l, h: torch.clamp(a, l, h),
                             [_t(x), lo, hi])
    return dispatch.call("clip", lambda a: torch.clamp(a, min, max), [_t(x)])


@register("lerp", category="math")
@_export
def lerp(x, y, weight, name=None):
    """x + weight * (y - x)."""
    if isinstance(weight, Tensor):
        return dispatch.call("lerp", lambda a, b, w: a + w * (b - a),
                             [_t(x), _t(y), weight])
    return dispatch.call("lerp", lambda a, b: a + weight * (b - a),
                         [_t(x), _t(y)])


@register("isclose", category="math", differentiable=False)
@_export
def isclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    return dispatch.call("isclose", lambda a, b: torch.isclose(
        a, b, rtol=rtol, atol=atol, equal_nan=equal_nan), [_t(x), _t(y)])


@register("allclose", category="math", differentiable=False)
@_export
def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    """Scalar bool tensor: every element isclose."""
    return dispatch.call("allclose", lambda a, b: torch.isclose(
        a, b, rtol=rtol, atol=atol, equal_nan=equal_nan).all(),
        [_t(x), _t(y)])


@register("equal_all", category="math", differentiable=False)
@_export
def equal_all(x, y, name=None):
    """Scalar bool tensor: the same shape and every element equal."""
    return dispatch.call("equal_all", lambda a, b: torch.full(
        (), a.shape == b.shape and torch.equal(a, b), device=a.device),
        [_t(x), _t(y)])


@register("nan_to_num", category="math")
@_export
def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return dispatch.call("nan_to_num", lambda a: torch.nan_to_num(
        a, nan=nan, posinf=posinf, neginf=neginf), [_t(x)])


@register("cast", category="math")
@_export
def cast(x, dtype):
    """Convert to ``dtype``; the gradient comes back in x's dtype."""
    d = convert_dtype(dtype)
    xt = _t(x)
    if xt.dtype == d:
        return xt
    return dispatch.call("cast", lambda a: a.to(d), [xt])
