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
           "logsumexp", "std", "var", "cumsum", "cumprod", "count_nonzero",
           "nansum", "nanmean", "median", "nanmedian", "quantile",
           "nanquantile", "mode", "cummax", "cummin", "logcumsumexp"]


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


def _scan(tfn, a, ax, d):
    """``tfn`` along ``ax`` (the flattened tensor when None); a 16-bit
    input is scanned in fp32 and rounded back, as the CPU's kernels do
    (the card's round every step, which drifts along a long axis)."""
    src = a.reshape(-1) if ax is None else a
    half = src.dtype in (torch.bfloat16, torch.float16) and d is None
    out = tfn(src.float() if half else src, 0 if ax is None else ax,
              dtype=d)
    return out.to(a.dtype) if half else out


@register("cumsum", category="reduction")
def cumsum(x, axis=None, dtype=None, name=None):
    """Inclusive cumulative sum along ``axis`` (of the flattened tensor
    when None)."""
    d = convert_dtype(dtype)
    ax = None if axis is None else _axis(axis)
    return dispatch.call("cumsum", lambda a: _scan(torch.cumsum, a, ax, d),
                         [_t(x)])


@register("cumprod", category="reduction")
def cumprod(x, dim=None, dtype=None, name=None):
    d = convert_dtype(dtype)
    ax = None if dim is None else _axis(dim)
    return dispatch.call("cumprod", lambda a: _scan(torch.cumprod, a, ax, d),
                         [_t(x)])


def count_nonzero(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return dispatch.call("count_nonzero", lambda a: torch.sum(
        a != 0, dim=_dims(a, ax), keepdim=keepdim), [_t(x)])


_make_reduce("nansum", lambda a, ax, keep: torch.nansum(
    a, dim=_dims(a, ax), keepdim=keep))
_make_reduce("nanmean", lambda a, ax, keep: torch.nanmean(
    a, dim=_dims(a, ax), keepdim=keep))


def _quantile(a: torch.Tensor, q, ax, keepdim, method, skip_nan):
    """numpy's quantile (methods linear, lower, higher, nearest,
    midpoint) of ``a`` over ``ax`` (every dim when None), through a
    sort; with ``skip_nan`` over each slice's non-NaN values (NaN where
    there are none). A sequence ``q`` puts its axis first."""
    dims = _dims(a, ax)
    nd = a.dim() or 1
    dims = (dims % nd,) if isinstance(dims, int) else tuple(d % nd
                                                           for d in dims)
    rest = [d for d in range(a.dim()) if d not in dims]
    moved = a.permute(rest + list(dims)).reshape(
        [a.shape[d] for d in rest] + [-1])
    s = torch.sort(moved, -1).values          # NaN sort last
    n_all = s.shape[-1]
    if skip_nan:
        n = (~torch.isnan(s)).sum(-1, keepdim=True)
    else:
        n = torch.full(s.shape[:-1] + (1,), n_all, device=a.device)
    qs = torch.as_tensor(q, dtype=torch.float64 if s.dtype == torch.float64
                         else torch.float32, device=a.device)
    qv = qs.reshape(-1)
    pos = qv * (n - 1).to(qv.dtype)           # [..., len(q)]
    lo = torch.floor(pos)
    hi = torch.ceil(pos)
    if method == "lower":
        idx_lo = idx_hi = lo
    elif method == "higher":
        idx_lo = idx_hi = hi
    elif method == "nearest":
        idx_lo = idx_hi = torch.round(pos)
    else:
        idx_lo, idx_hi = lo, hi
    g_lo = torch.gather(s, -1, idx_lo.long().clamp(0, n_all - 1))
    g_hi = torch.gather(s, -1, idx_hi.long().clamp(0, n_all - 1))
    if method == "midpoint":
        out = (g_lo + g_hi) / 2
    elif method == "linear":
        out = g_lo + (g_hi - g_lo) * (pos - lo).to(s.dtype)
    else:
        out = g_lo
    if skip_nan:
        out = torch.where(n > 0, out, torch.full_like(out, float("nan")))
    out = out.movedim(-1, 0)                  # [len(q), ...rest]
    if keepdim:
        shape = list(a.shape)
        for d in dims:
            shape[d] = 1
        out = out.reshape([out.shape[0]] + shape)
    if qs.dim() == 0:
        out = out[0]
    return out


def _make_quantile(name, skip_nan):
    def op(x, q, axis=None, keepdim=False, interpolation="linear",
           name_=None):
        ax = _axis(axis)
        return dispatch.call(name, lambda a: _quantile(
            a, q, ax, keepdim, interpolation, skip_nan), [_t(x)])
    op.__name__ = op.__qualname__ = name
    op.__doc__ = (f"Quantiles ``q`` over ``axis`` (every axis when None)"
                  f"{', NaNs skipped' if skip_nan else ''}, numpy's "
                  f"interpolation methods.")
    return register(name, category="reduction")(op)


quantile = _make_quantile("quantile", False)
nanquantile = _make_quantile("nanquantile", True)


@register("median", category="reduction")
def median(x, axis=None, keepdim=False, mode="avg", name=None):
    """The median over ``axis``: the mean of the middle pair for an even
    count (``mode="avg"``), or the lower of it (``mode="min"``)."""
    ax = _axis(axis)
    how = "lower" if mode == "min" else "linear"
    return dispatch.call("median", lambda a: _quantile(
        a, 0.5, ax, keepdim, how, False), [_t(x)])


@register("nanmedian", category="reduction")
def nanmedian(x, axis=None, keepdim=False, name=None):
    """The median over ``axis`` of the non-NaN values."""
    ax = _axis(axis)
    return dispatch.call("nanmedian", lambda a: _quantile(
        a, 0.5, ax, keepdim, "linear", True), [_t(x)])


@register("mode", category="reduction")
def mode(x, axis=-1, keepdim=False, name=None):
    """(most frequent value along ``axis``, the index of its first
    occurrence): among equally frequent values the smallest, as the JAX
    package's. Runs of a sort, so O(n log n) a slice."""
    def f(a):
        ax = axis % a.dim()
        moved = a.movedim(ax, -1)
        s = torch.sort(moved, -1).values
        new = torch.ones_like(s, dtype=torch.bool)
        new[..., 1:] = s[..., 1:] != s[..., :-1]
        run = torch.cumsum(new.long(), -1) - 1
        counts = torch.zeros(s.shape, dtype=torch.long, device=a.device)
        counts.scatter_add_(-1, run, torch.ones_like(run))
        best = torch.argmax(counts, -1, keepdim=True)   # first: smallest
        first = torch.argmax((run == best).to(torch.int8), -1, keepdim=True)
        vals = torch.gather(s, -1, first)
        idx = torch.argmax((moved == vals).to(torch.int8), -1, keepdim=True)
        if keepdim:
            return vals.movedim(-1, ax), idx.movedim(-1, ax)
        return vals[..., 0], idx[..., 0]
    v, i = dispatch.call("mode", f, [_t(x)])
    return v, i


def _cum_arg(name, tfn, x, axis, dtype):
    d = convert_dtype(dtype)

    def f(a):
        if axis is None:
            a, ax = a.reshape(-1), 0
        else:
            ax = _axis(axis)
        v, i = tfn(a, ax)
        return v, i.to(d)
    v, i = dispatch.call(name, f, [_t(x)])
    return v, i


@register("cummax", category="reduction")
def cummax(x, axis=None, dtype="int64", name=None):
    """(running maximum along ``axis``, the index it came from)."""
    return _cum_arg("cummax", torch.cummax, x, axis, dtype)


@register("cummin", category="reduction")
def cummin(x, axis=None, dtype="int64", name=None):
    """(running minimum along ``axis``, the index it came from)."""
    return _cum_arg("cummin", torch.cummin, x, axis, dtype)


@register("logcumsumexp", category="reduction")
def logcumsumexp(x, axis=None, dtype=None, name=None):
    """log(cumsum(exp(x))) along ``axis``, computed stably (a 16-bit
    input in fp32, ``_scan``)."""
    ax = None if axis is None else _axis(axis)
    return dispatch.call("logcumsumexp", lambda a: _scan(
        lambda v, dim, dtype: torch.logcumsumexp(v, dim), a, ax, None),
        [_t(x)])
