"""Reductions (counterpart of ``paddle_tpu/ops/reduction.py``): each a
plain torch body behind ``dispatch.call``. ``max``/``min`` return values
only, as Paddle's do. An integer or bool sum/prod keeps the JAX
package's dtype (int32 for bool and int32 input) where torch would widen
to int64; an integer or bool mean is the float32 mean, as ``jnp.mean``
gives it.
"""
from __future__ import annotations

import torch

from ..core import dispatch
from ..core.dtype import convert_dtype
from ..core.tensor import Tensor, as_tensor
from .registry import register

__all__ = ["sum", "mean", "max", "min", "amax", "amin", "prod", "any", "all",
           "logsumexp", "std", "var", "cumsum", "cumprod", "count_nonzero"]


def _t(x):
    return x if isinstance(x, Tensor) else as_tensor(x)


def _axis(axis):
    if axis is None:
        return None
    if isinstance(axis, Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(a: torch.Tensor, ax):
    """torch's ``dim`` argument: every dim for None."""
    return tuple(range(a.dim())) if ax is None else ax


def _keep_int(a: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    if a.dtype in (torch.bool, torch.int32, torch.int16, torch.int8,
                   torch.uint8):
        return out.to(torch.int32)
    return out


def _make_reduce(name, body, differentiable=True):
    def op(x, axis=None, keepdim=False, name_=None, dtype=None):
        ax = _axis(axis)
        d = convert_dtype(dtype)

        def f(a):
            out = body(a, ax, keepdim)
            return out.to(d) if d is not None else out
        return dispatch.call(name, f, [_t(x)])
    op.__name__ = op.__qualname__ = name
    op.__doc__ = (f"Reduce ``{name}`` over ``axis`` (every axis when None), "
                  f"with optional keepdim and dtype.")
    register(name, category="reduction", differentiable=differentiable)(op)
    globals()[name] = op
    return op


def _sum(a, ax, keep):
    return _keep_int(a, torch.sum(a, dim=_dims(a, ax), keepdim=keep))


def _prod(a, ax, keep):
    """torch.prod takes one dim: reduce them from the last (this module's
    ``max``/``sum`` are the ops, not the builtins)."""
    if a.dim() == 0:
        return a
    dims = (ax,) if isinstance(ax, int) else _dims(a, ax)
    for d in sorted((d % a.dim() for d in dims), reverse=True):
        a = torch.prod(a, dim=d, keepdim=keep)
    return a


_make_reduce("sum", _sum)
_make_reduce("mean", lambda a, ax, keep: torch.mean(
    a if a.is_floating_point() or a.is_complex() else a.float(),
    dim=_dims(a, ax), keepdim=keep))
_make_reduce("max", lambda a, ax, keep: torch.amax(
    a, dim=_dims(a, ax), keepdim=keep))
_make_reduce("min", lambda a, ax, keep: torch.amin(
    a, dim=_dims(a, ax), keepdim=keep))
_make_reduce("amax", lambda a, ax, keep: torch.amax(
    a, dim=_dims(a, ax), keepdim=keep))
_make_reduce("amin", lambda a, ax, keep: torch.amin(
    a, dim=_dims(a, ax), keepdim=keep))
_make_reduce("prod", lambda a, ax, keep: _keep_int(a, _prod(a, ax, keep)))
_make_reduce("any", lambda a, ax, keep: torch.any(
    a, dim=_dims(a, ax), keepdim=keep), differentiable=False)
_make_reduce("all", lambda a, ax, keep: torch.all(
    a, dim=_dims(a, ax), keepdim=keep), differentiable=False)


@register("logsumexp", category="reduction")
def logsumexp(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return dispatch.call("logsumexp", lambda a: torch.logsumexp(
        a, dim=_dims(a, ax), keepdim=keepdim), [_t(x)])


@register("std", category="reduction")
def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = _axis(axis)
    return dispatch.call("std", lambda a: torch.std(
        a, dim=_dims(a, ax), correction=int(unbiased), keepdim=keepdim),
        [_t(x)])


@register("var", category="reduction")
def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = _axis(axis)
    return dispatch.call("var", lambda a: torch.var(
        a, dim=_dims(a, ax), correction=int(unbiased), keepdim=keepdim),
        [_t(x)])


@register("cumsum", category="reduction")
def cumsum(x, axis=None, dtype=None, name=None):
    """Inclusive cumulative sum along ``axis`` (of the flattened tensor
    when None)."""
    d = convert_dtype(dtype)

    def f(a):
        if axis is None:
            return torch.cumsum(a.reshape(-1), 0, dtype=d)
        return torch.cumsum(a, _axis(axis), dtype=d)
    return dispatch.call("cumsum", f, [_t(x)])


@register("cumprod", category="reduction")
def cumprod(x, dim=None, dtype=None, name=None):
    d = convert_dtype(dtype)

    def f(a):
        if dim is None:
            return torch.cumprod(a.reshape(-1), 0, dtype=d)
        return torch.cumprod(a, _axis(dim), dtype=d)
    return dispatch.call("cumprod", f, [_t(x)])


def count_nonzero(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return dispatch.call("count_nonzero", lambda a: torch.sum(
        a != 0, dim=_dims(a, ax), keepdim=keepdim), [_t(x)])
