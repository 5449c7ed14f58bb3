"""The rest of the top-level tensor functions (counterpart of
``paddle_tpu/ops/tail.py``): elementwise odds and ends, the numpy-style
stacking and splitting family, structural ops, and three random draws.
Each is a plain torch body behind ``dispatch.call``; the random ones
draw from the current device's Paddle-API generator.
"""
from __future__ import annotations

import itertools
import math as _math

import numpy as np
import torch

from ..core import dispatch
from ..core.generator import default_generator
from ..core.place import current_device
from ..core.tensor import Tensor, as_tensor, graph_break
from .reduction import _scan
from .registry import register

__all__ = []


def _export(fn):
    __all__.append(fn.__name__)
    return fn


def _t(x):
    return x if isinstance(x, Tensor) else as_tensor(x)


def _u(name, tfn, x):
    return dispatch.call(name, tfn, [_t(x)])


# ------------------------------------------------------------ elementwise
@_export
@register("rad2deg", category="math")
def rad2deg(x, name=None):
    """Radians to degrees."""
    return _u("rad2deg", lambda a: a * (180.0 / _math.pi), x)


@_export
@register("deg2rad", category="math")
def deg2rad(x, name=None):
    """Degrees to radians."""
    return _u("deg2rad", lambda a: a * (_math.pi / 180.0), x)


@_export
@register("sinc", category="math")
def sinc(x, name=None):
    """sin(pi x) / (pi x), 1 at 0."""
    return _u("sinc", torch.sinc, x)


@_export
@register("sgn", category="math")
def sgn(x, name=None):
    """The sign of a real tensor; x / |x| (0 at 0) of a complex one."""
    return _u("sgn", torch.sgn, x)


@_export
@register("signbit", category="math", differentiable=False)
def signbit(x, name=None):
    """True where the sign bit is set, -0.0 included."""
    return _u("signbit", torch.signbit, x)


@_export
@register("frexp", category="math", differentiable=False)
def frexp(x, name=None):
    """(mantissa in [0.5, 1), exponent in x's dtype)."""
    def f(a):
        m, e = torch.frexp(a)
        return m, e.to(a.dtype)
    return dispatch.call("frexp", f, [_t(x)])


@_export
@register("isneginf", category="math", differentiable=False)
def isneginf(x, name=None):
    return _u("isneginf", torch.isneginf, x)


@_export
@register("isposinf", category="math", differentiable=False)
def isposinf(x, name=None):
    return _u("isposinf", torch.isposinf, x)


@_export
@register("isreal", category="math", differentiable=False)
def isreal(x, name=None):
    """True where the imaginary part is zero."""
    return _u("isreal", torch.isreal, x)


@_export
@register("multigammaln", category="math")
def multigammaln(x, p, name=None):
    """The log of the multivariate gamma function of order ``p``."""
    return _u("multigammaln", lambda a: torch.special.multigammaln(
        a, int(p)), x)


# ------------------------------------------------------------- reductions
@_export
@register("cumulative_trapezoid", category="math")
def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    """The cumulative trapezoid rule along ``axis`` (one shorter than
    ``y`` there)."""
    def f(ya, *rest):
        a = torch.movedim(ya, axis, -1)
        mids = (a[..., 1:] + a[..., :-1]) * 0.5
        if rest:
            widths = torch.diff(torch.movedim(rest[0], axis, -1), dim=-1)
        else:
            widths = dx if dx is not None else 1.0
        # a 16-bit y is scanned in fp32, as cumsum does
        return torch.movedim(_scan(torch.cumsum, mids * widths, -1, None),
                             -1, axis)
    ins = [_t(y)] + ([_t(x)] if x is not None else [])
    return dispatch.call("cumulative_trapezoid", f, ins)


@_export
@register("pdist", category="math")
def pdist(x, p=2.0, name=None):
    """Distances between the rows of ``x``, pair (i, j) for i < j in
    row-major order (only real pairs: no zero distance whose sqrt would
    give an infinite gradient)."""
    def f(a):
        iu, ju = np.triu_indices(a.shape[0], k=1)
        iu = torch.as_tensor(iu, device=a.device)
        ju = torch.as_tensor(ju, device=a.device)
        diff = a[iu] - a[ju]
        if p == 2.0:
            return torch.sqrt((diff * diff).sum(-1))
        return (diff.abs() ** p).sum(-1) ** (1.0 / p)
    return _u("pdist", f, x)


def _bin_index(a: torch.Tensor, lo, hi, bins: int) -> torch.Tensor:
    """The bin of each element for ``bins`` equal bins over [lo, hi]
    (numpy's edges; the last bin takes hi), -1 outside."""
    lo = torch.as_tensor(lo, device=a.device, dtype=a.dtype)
    hi = torch.as_tensor(hi, device=a.device, dtype=a.dtype)
    edges = lo + (hi - lo) * torch.linspace(0, 1, bins + 1, device=a.device,
                                            dtype=a.dtype)
    idx = torch.searchsorted(edges.contiguous(), a.contiguous(),
                             right=True) - 1
    idx = torch.where(a == edges[-1], torch.full_like(idx, bins - 1), idx)
    inside = (a >= edges[0]) & (a <= edges[-1])
    return torch.where(inside, idx, torch.full_like(idx, -1)), edges


def histogram_counts(a: torch.Tensor, bins: int, lo, hi, weight=None):
    """(counts or weight sums over ``bins`` equal bins of [lo, hi],
    edges): the body of ``histogram`` and ``histogramdd``."""
    idx, edges = _bin_index(a, lo, hi, bins)
    ok = idx >= 0
    w = (torch.ones_like(a) if weight is None else weight.to(a.dtype))
    out = torch.zeros(bins, dtype=a.dtype, device=a.device)
    # masked by weight, not by selection: no data-dependent shape
    out.index_add_(0, idx.clamp_min(0), torch.where(ok, w, 0))
    return out, edges


@_export
@register("histogramdd", category="math", differentiable=False)
def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """The histogram of the rows of x (N, D) over D dims: (hist, the edges
    of each dim). ``ranges`` None takes each dim's min and max."""
    ins = [_t(x)] + ([_t(weights)] if weights is not None else [])

    def f(a, *w):
        a = a.float()
        d = a.shape[-1]
        nb = [bins] * d if isinstance(bins, int) else [int(b) for b in bins]
        flat = torch.zeros(a.shape[0], dtype=torch.long, device=a.device)
        ok = torch.ones(a.shape[0], dtype=torch.bool, device=a.device)
        edges = []
        for k in range(d):
            col = a[:, k]
            if ranges is None:
                lo, hi = col.min(), col.max()
            else:
                lo, hi = float(ranges[2 * k]), float(ranges[2 * k + 1])
            lo_t = torch.as_tensor(lo, device=a.device, dtype=torch.float32)
            hi_t = torch.as_tensor(hi, device=a.device, dtype=torch.float32)
            # numpy widens an empty range by one on each side
            same = lo_t == hi_t
            lo_t = torch.where(same, lo_t - 0.5, lo_t)
            hi_t = torch.where(same, hi_t + 0.5, hi_t)
            idx, e = _bin_index(col, lo_t, hi_t, nb[k])
            ok &= idx >= 0
            flat = flat * nb[k] + idx.clamp_min(0)
            edges.append(e)
        wt = w[0].float() if w else torch.ones(a.shape[0], device=a.device)
        hist = torch.zeros(int(np.prod(nb)), dtype=torch.float32,
                           device=a.device)
        hist.index_add_(0, flat, torch.where(ok, wt, 0))
        hist = hist.reshape(nb)
        if density:
            vol = torch.ones(nb, dtype=torch.float32, device=a.device)
            for k, e in enumerate(edges):
                shape = [1] * d
                shape[k] = nb[k]
                vol = vol * torch.diff(e).reshape(shape)
            hist = hist / hist.sum() / vol
        return [hist] + edges
    out = dispatch.call("histogramdd", f, ins,
                        differentiable_mask=[False] * len(ins))
    return out[0], list(out[1:])


# ------------------------------------------------------------ predicates
@_export
def is_complex(x):
    return _t(x)._data.is_complex()


@_export
def is_integer(x):
    d = _t(x)._data
    return not (d.is_floating_point() or d.is_complex()) \
        and d.dtype != torch.bool


@_export
def is_floating_point(x):
    return _t(x)._data.is_floating_point()


@_export
def is_empty(x, name=None):
    """Whether x has no element, as a bool tensor."""
    d = _t(x)._data
    return Tensor(torch.full((), d.numel() == 0, device=d.device))


@_export
def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


@_export
def tolist(x):
    return _t(x).tolist()


# ------------------------------------------------------------- structure
@_export
@register("block_diag", category="manipulation")
def block_diag(inputs, name=None):
    """The block-diagonal matrix of a list of matrices."""
    return dispatch.call("block_diag", lambda *a: torch.block_diag(*a),
                         [_t(i) for i in inputs])


def _split_n(op_name, axis):
    def fn(x, num_or_indices, name=None):
        def f(a):
            ax = 0 if op_name == "hsplit" and a.dim() == 1 else axis
            if ax >= a.dim():
                raise ValueError(f"{op_name} expects ndim > {ax}")
            n = a.shape[ax]
            if isinstance(num_or_indices, int):
                if n % num_or_indices:
                    raise ValueError(f"{op_name}: {n} does not split into "
                                     f"{num_or_indices} equal parts")
                return tuple(torch.split(a, n // num_or_indices, ax))
            return tuple(torch.tensor_split(a, list(num_or_indices), ax))
        return list(dispatch.call(op_name, f, [_t(x)]))
    fn.__name__ = fn.__qualname__ = op_name
    fn.__doc__ = f"Split along axis {axis} (numpy's {op_name})."
    return _export(register(op_name, category="manipulation")(fn))


hsplit = _split_n("hsplit", 1)
vsplit = _split_n("vsplit", 0)
dsplit = _split_n("dsplit", 2)


def _stack_as(op_name, tfn):
    def fn(x, name=None):
        return dispatch.call(op_name, lambda *a: tfn(a), [_t(i) for i in x])
    fn.__name__ = fn.__qualname__ = op_name
    fn.__doc__ = f"numpy's {op_name} of a list of tensors."
    return _export(register(op_name, category="manipulation")(fn))


hstack = _stack_as("hstack", torch.hstack)
vstack = _stack_as("vstack", torch.vstack)
dstack = _stack_as("dstack", torch.dstack)
column_stack = _stack_as("column_stack", torch.column_stack)
row_stack = _stack_as("row_stack", torch.vstack)


@_export
@register("unflatten", category="manipulation")
def unflatten(x, axis, shape, name=None):
    """Split dim ``axis`` into ``shape``."""
    return dispatch.call("unflatten", lambda a: torch.unflatten(
        a, axis, [int(s) for s in shape]), [_t(x)])


@_export
@register("as_strided", category="manipulation", differentiable=False)
def as_strided(x, shape, stride, offset=0, name=None):
    """The elements of x's flattened (contiguous) storage at ``offset``
    plus the strides, as a new tensor of ``shape``."""
    def f(a):
        return torch.as_strided(a.contiguous().reshape(-1), tuple(shape),
                                tuple(stride), offset).clone()
    return dispatch.call("as_strided", f, [_t(x)])


@_export
@register("index_fill", category="manipulation")
def index_fill(x, index, axis, value, name=None):
    """``value`` at the ``index`` positions along ``axis``."""
    def f(a, idx):
        return torch.index_fill(a, axis, idx.long().reshape(-1), value)
    return dispatch.call("index_fill", f, [_t(x), _t(index)],
                         differentiable_mask=[True, False])


@_export
@register("diagonal_scatter", category="manipulation")
def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    """``y`` written onto the ``offset`` diagonal of the (axis1, axis2)
    planes."""
    def f(a, b):
        return torch.diagonal_scatter(a, b.to(a.dtype), offset, axis1, axis2)
    return dispatch.call("diagonal_scatter", f, [_t(x), _t(y)])


@_export
@register("combinations", category="manipulation", differentiable=False)
def combinations(x, r=2, with_replacement=False, name=None):
    """Every r-combination of a 1-D tensor's elements, one a row."""
    xt = _t(x)
    n = xt.shape[0]
    it = (itertools.combinations_with_replacement(range(n), r)
          if with_replacement else itertools.combinations(range(n), r))
    idx = np.array(list(it), np.int64).reshape(-1, r)
    return dispatch.call("combinations", lambda a: a[torch.as_tensor(
        idx, device=a.device)], [xt])


@_export
@register("scatter_nd", category="manipulation")
def scatter_nd(index, updates, shape, name=None):
    """``updates`` added into zeros of ``shape`` at the multi-dim
    ``index`` rows."""
    def f(idx, upd):
        out = torch.zeros(tuple(int(s) for s in shape), dtype=upd.dtype,
                          device=upd.device)
        return out.index_put(tuple(torch.movedim(idx.long(), -1, 0)), upd,
                             accumulate=True)
    return dispatch.call("scatter_nd", f, [_t(index), _t(updates)],
                         differentiable_mask=[False, True])


@_export
@register("add_n", category="math")
def add_n(inputs, name=None):
    """The elementwise sum of a list of tensors."""
    ts = [_t(i) for i in (inputs if isinstance(inputs, (list, tuple))
                          else [inputs])]

    def f(*a):
        out = a[0]
        for b in a[1:]:
            out = out + b
        return out.clone() if len(a) == 1 else out
    return dispatch.call("add_n", f, ts)


@_export
@register("reverse", category="manipulation")
def reverse(x, axis, name=None):
    """``flip`` under its old name."""
    from .manipulation import flip
    return flip(x, axis)


# ------------------------------------------------------------------ random
@_export
@register("binomial", category="random", differentiable=False)
def binomial(count, prob, name=None):
    """Binomial(count, prob) draws, int32."""
    graph_break("paddle.binomial")
    ct, pt = _t(count), _t(prob)
    n, p = torch.broadcast_tensors(ct._data.float(), pt._data.float())
    g = default_generator(n.device)
    return Tensor(torch.binomial(n.contiguous(), p.contiguous(),
                                 generator=g).to(torch.int32))


@_export
@register("standard_gamma", category="random", differentiable=False)
def standard_gamma(x, name=None):
    """Gamma(alpha=x, scale=1) draws, in x's float dtype (float32 for an
    integer x)."""
    graph_break("paddle.standard_gamma")
    d = _t(x)._data
    out_dtype = d.dtype if d.is_floating_point() else torch.float32
    alpha = d.float()
    g = default_generator(alpha.device)
    return Tensor(torch._standard_gamma(alpha, generator=g).to(out_dtype))


@_export
@register("log_normal", category="random", differentiable=False)
def log_normal(mean=1.0, std=2.0, shape=None, name=None):
    """exp(N(mean, std)) draws of ``shape``."""
    graph_break("paddle.log_normal")
    dev = current_device()
    z = torch.randn(tuple(shape or ()), generator=default_generator(dev),
                    device=dev)
    return Tensor(torch.exp(z * std + mean))
