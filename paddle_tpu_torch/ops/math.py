"""Elementwise math, comparison and logic ops (counterpart of
``paddle_tpu/ops/math.py``): each a plain torch body behind
``dispatch.call``.

A Python scalar operand becomes a 0-d tensor, which torch's promotion
treats as the JAX package's weak types do: ``int32 + 2.5`` is float32,
``bf16 * 2.0`` stays bf16.
"""
from __future__ import annotations

import math

import torch

from ..core import dispatch
from ..core.dtype import convert_dtype
from ..core.tensor import Tensor, as_tensor
from .registry import register

__all__ = []

builtins_max, builtins_min = max, min


def _export(fn):
    __all__.append(fn.__name__)
    return fn


def _t(x):
    return x if isinstance(x, Tensor) else as_tensor(x)


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar as a 0-d operand beside ``like``: of like's dtype
    where the kinds agree (an int with an integer tensor, a float with a
    float one), as the JAX package's weak types give, so a 0-d int32
    ``i + 1`` stays int32. A fill, not a host-to-device copy: no sync on
    the card."""
    dt = None
    if isinstance(v, int) and not isinstance(v, bool):
        if not (like.is_floating_point() or like.is_complex()) \
                and like.dtype != torch.bool:
            dt = like.dtype
    elif isinstance(v, float) and (like.is_floating_point()
                                   or like.is_complex()):
        dt = like.dtype
    return torch.full((), v, dtype=dt, device=like.device)


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
_make_binary("nextafter", torch.nextafter)
_make_binary("copysign", torch.copysign)
_make_binary("heaviside", lambda a, b: torch.heaviside(
    a, b.to(torch.promote_types(a.dtype, b.dtype))))
_make_binary("gcd", torch.gcd)
_make_binary("lcm", torch.lcm)
_make_binary("ldexp", lambda a, b: torch.ldexp(
    a, b) if a.is_floating_point() else torch.ldexp(a.float(), b))
_make_binary("bitwise_left_shift", torch.bitwise_left_shift)
_make_binary("bitwise_right_shift", torch.bitwise_right_shift)

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
_make_unary("frac", torch.frac)
_make_unary("asinh", torch.asinh)
_make_unary("acosh", torch.acosh)
_make_unary("atanh", torch.atanh)
_make_unary("logit", torch.logit)
_make_unary("digamma", torch.digamma)
_make_unary("lgamma", torch.lgamma)
_make_unary("i0", torch.special.i0)
_make_unary("i1", torch.special.i1)
# a real tensor's conj and real are copies of it (torch returns the
# tensor itself, which would make an op's output its input); its imag
# is zeros, as jnp.imag gives
_make_unary("conj", lambda a: torch.conj_physical(a) if a.is_complex()
            else a.clone())
def _angle(a):
    """The argument of a complex number; of a real one pi where it is
    negative, else 0, NaN kept (written out: torch's has no bf16 kernel
    on the card)."""
    if a.is_complex():
        return torch.angle(a)
    if not a.is_floating_point():
        a = a.float()
    return torch.where(a < 0, torch.full_like(a, math.pi),
                       torch.where(torch.isnan(a), a, torch.zeros_like(a)))


_make_unary("angle", _angle)
_make_unary("real", lambda a: torch.real(a).clone() if a.is_complex()
            else a.clone())
_make_unary("imag", lambda a: torch.imag(a).clone() if a.is_complex()
            else torch.zeros_like(a))
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


@register("stanh", category="math")
@_export
def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    """scale_b * tanh(scale_a * x)."""
    return dispatch.call("stanh", lambda a: scale_b * torch.tanh(
        scale_a * a), [_t(x)])


@register("multiplex", category="math")
@_export
def multiplex(inputs, index, name=None):
    """Row i of the result is row i of ``inputs[index[i]]``."""
    def f(*args):
        *xs, idx = args
        stacked = torch.stack(xs, 0)
        sel = idx.reshape(1, -1, *([1] * (stacked.dim() - 2))).long()
        return torch.take_along_dim(stacked, sel.expand(
            1, *stacked.shape[1:]), 0)[0]
    return dispatch.call("multiplex", f, [_t(i) for i in inputs]
                         + [_t(index)])


@register("trapezoid", category="math")
@_export
def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    """The trapezoid rule along ``axis`` (sample points ``x``, or a
    spacing ``dx``, 1 by default)."""
    if x is not None:
        return dispatch.call("trapezoid", lambda yy, xx: torch.trapezoid(
            yy, xx, dim=axis), [_t(y), _t(x)])
    return dispatch.call("trapezoid", lambda yy: torch.trapezoid(
        yy, dx=dx or 1.0, dim=axis), [_t(y)])


@register("diff", category="math")
@_export
def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    """The n-th forward difference along ``axis``, with optional
    ``prepend``/``append`` values."""
    ins = [_t(x)] + [_t(v) for v in (prepend, append) if v is not None]

    def f(a, *rest):
        pre = rest[0] if prepend is not None else None
        app = rest[-1] if append is not None else None
        return torch.diff(a, n=n, dim=axis, prepend=pre, append=app)
    return dispatch.call("diff", f, ins)


@register("gammaln", category="math")
@_export
def gammaln(x, name=None):
    """log|Gamma(x)| (lgamma)."""
    return dispatch.call("gammaln", torch.lgamma, [_t(x)])


@register("polygamma", category="math")
@_export
def polygamma(x, n, name=None):
    """The n-th derivative of digamma."""
    return dispatch.call("polygamma", lambda a: torch.polygamma(n, a),
                         [_t(x)])


@register("i0e", category="math")
@_export
def i0e(x, name=None):
    """Exponentially scaled modified Bessel function I0."""
    return dispatch.call("i0e", torch.special.i0e, [_t(x)])


@register("i1e", category="math")
@_export
def i1e(x, name=None):
    """Exponentially scaled modified Bessel function I1."""
    return dispatch.call("i1e", torch.special.i1e, [_t(x)])


@register("increment", category="math")
@_export
def increment(x, value=1.0, name=None):
    """x + value, written into x when x is a Tensor."""
    out = dispatch.call("increment", lambda a: a + value, [_t(x)])
    if isinstance(x, Tensor):
        x._swap_payload(out._data)
        return x
    return out


@register("renorm", category="math")
@_export
def renorm(x, p, axis, max_norm, name=None):
    """Scale each slice along ``axis`` whose p-norm exceeds ``max_norm``
    down to ``max_norm``."""
    def f(a):
        moved = torch.movedim(a, axis, 0)
        flat = moved.reshape(moved.shape[0], -1)
        norms = torch.sum(flat.abs() ** p, 1) ** (1.0 / p)
        scale = torch.where(norms > max_norm,
                            max_norm / torch.clamp_min(norms, 1e-12),
                            torch.ones_like(norms))
        return torch.movedim((flat * scale[:, None]).reshape(moved.shape),
                             0, axis)
    return dispatch.call("renorm", f, [_t(x)])


def _diag_index(rows, cols, offset, device):
    """Row and column indices of the ``offset`` diagonal of a rows x cols
    matrix."""
    if offset >= 0:
        n = builtins_max(builtins_min(rows, cols - offset), 0)
        i = torch.arange(n, device=device)
        return i, i + offset
    n = builtins_max(builtins_min(rows + offset, cols), 0)
    i = torch.arange(n, device=device)
    return i - offset, i


@register("fill_diagonal", category="math")
@_export
def fill_diagonal(x, value, offset=0, wrap=False, name=None):
    """``value`` on the ``offset`` diagonal of the last two dims; with
    ``wrap`` a tall matrix's main diagonal starts again after every
    cols + 1 rows (numpy's fill_diagonal)."""
    def f(a):
        rows, cols = a.shape[-2], a.shape[-1]
        out = a.clone()
        if wrap and offset == 0 and rows > cols:
            r = torch.arange(rows, device=a.device)
            c = r % (cols + 1)
            ok = c < cols
            out[..., r[ok], c[ok]] = value
            return out
        r, c = _diag_index(rows, cols, offset, a.device)
        out[..., r, c] = value
        return out
    return dispatch.call("fill_diagonal", f, [_t(x)])


@register("fill_diagonal_tensor", category="math")
@_export
def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1, name=None):
    """Write ``y`` onto the ``offset`` diagonal of the (dim1, dim2)
    planes of ``x``; y's last axis runs along the diagonal."""
    def f(a, v):
        nd = a.dim()
        d1, d2 = dim1 % nd, dim2 % nd
        perm = [i for i in range(nd) if i not in (d1, d2)] + [d1, d2]
        ap = a.permute(perm).clone()
        r, c = _diag_index(ap.shape[-2], ap.shape[-1], offset, a.device)
        ap[..., r, c] = v.to(a.dtype)
        inv = [perm.index(i) for i in range(nd)]
        return ap.permute(inv)
    return dispatch.call("fill_diagonal_tensor", f, [_t(x), _t(y)])


def _in_fp32(tfn):
    """``tfn`` over 16-bit inputs computed in fp32 and rounded back (the
    card has no 16-bit kernel of the incomplete gamma functions)."""
    def f(a, b):
        if a.dtype in (torch.bfloat16, torch.float16):
            return tfn(a.float(), b.float()).to(a.dtype)
        return tfn(a, b)
    return f


@register("gammainc", category="math")
@_export
def gammainc(x, y, name=None):
    """The regularized lower incomplete gamma function P(x, y)."""
    return dispatch.call("gammainc", _in_fp32(torch.special.gammainc),
                         [_t(x), _t(y)])


@register("gammaincc", category="math")
@_export
def gammaincc(x, y, name=None):
    """The regularized upper incomplete gamma function Q(x, y)."""
    return dispatch.call("gammaincc", _in_fp32(torch.special.gammaincc),
                         [_t(x), _t(y)])


@register("reduce_as", category="math")
@_export
def reduce_as(x, target, name=None):
    """Sum ``x`` down to ``target``'s (broadcastable) shape."""
    tshape = tuple(_t(target).shape)

    def f(a):
        extra = a.dim() - len(tshape)
        axes = tuple(range(extra)) + tuple(
            i + extra for i, s in enumerate(tshape) if a.shape[i + extra] != s)
        out = torch.sum(a, dim=axes) if axes else a.clone()
        return out.reshape(tshape)
    return dispatch.call("reduce_as", f, [_t(x)])
