"""Tensor creation and random ops (counterpart of
``paddle_tpu/ops/creation.py``). New tensors land on the current device
(``core.place.current_device``); random ops draw from that device's
Paddle-API generator (``core.generator.default_generator``), never from
torch's global RNG. A random op draws outside the dispatcher, so under
``to_static``'s capture it is a graph break: a replay would repeat the
recorded draw.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dispatch
from ..core.dtype import convert_dtype, default_float_dtype
from ..core.generator import default_generator
from ..core.place import current_device, resolve_device
from ..core.tensor import Tensor, as_tensor, graph_break
from .manipulation import _int
from .registry import register

__all__ = [
    "to_tensor", "zeros", "ones", "full", "zeros_like", "ones_like",
    "full_like", "empty", "empty_like", "arange", "linspace", "eye", "tril",
    "triu", "rand", "randn", "randint", "uniform", "normal",
    "standard_normal", "randperm", "one_hot", "clone", "assign",
    "bernoulli", "complex", "diag", "diagflat", "logspace",
    "meshgrid", "multinomial", "poisson", "polar", "randint_like",
    "tril_indices", "triu_indices",
]


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """A Tensor from Python/numpy/torch data (paddle.to_tensor); ``place``
    (a ``Place`` or a device string) overrides the current device."""
    device = None
    if place is not None:
        device = (place.torch_device() if hasattr(place, "torch_device")
                  else resolve_device(place))
    return as_tensor(data, dtype=dtype, stop_gradient=stop_gradient,
                     device=device)


def _shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.tolist())
    if isinstance(shape, (int, np.integer, torch.SymInt)):
        return (_int(shape),)
    return tuple(_int(s) for s in shape)


def _float(dtype):
    return convert_dtype(dtype) or default_float_dtype()


@register("zeros", category="creation", differentiable=False)
def zeros(shape, dtype=None, name=None):
    return Tensor(torch.zeros(_shape(shape), dtype=_float(dtype),
                              device=current_device()))


@register("ones", category="creation", differentiable=False)
def ones(shape, dtype=None, name=None):
    return Tensor(torch.ones(_shape(shape), dtype=_float(dtype),
                             device=current_device()))


@register("full", category="creation", differentiable=False)
def full(shape, fill_value, dtype=None, name=None):
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    d = convert_dtype(dtype)
    if d is None and isinstance(fill_value, float):
        d = default_float_dtype()
    return Tensor(torch.full(_shape(shape), fill_value, dtype=d,
                             device=current_device()))


def _like(x, fn, dtype, *args):
    x = as_tensor(x)
    return Tensor(fn(x._data, *args, dtype=convert_dtype(dtype)))


def zeros_like(x, dtype=None, name=None):
    return _like(x, torch.zeros_like, dtype)


def ones_like(x, dtype=None, name=None):
    return _like(x, torch.ones_like, dtype)


def full_like(x, fill_value, dtype=None, name=None):
    return _like(x, torch.full_like, dtype, fill_value)


def empty(shape, dtype=None, name=None):
    """Zero-filled, as in the JAX package."""
    return zeros(shape, dtype)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


@register("arange", category="creation", differentiable=False)
def arange(start=0, end=None, step=1, dtype=None, name=None):
    """Values in [start, end) by ``step``: int64 when all three are ints,
    else float32, unless ``dtype`` says otherwise."""
    def _v(v):
        return v.item() if isinstance(v, Tensor) else v
    start, end, step = _v(start), _v(end), _v(step)
    if end is None:
        start, end = 0, start
    d = convert_dtype(dtype)
    if d is None:
        d = (torch.int64 if all(isinstance(v, (int, np.integer,
                                               torch.SymInt))
                                for v in (start, end, step))
             else default_float_dtype())
    return Tensor(torch.arange(start, end, step, dtype=d,
                               device=current_device()))


def linspace(start, stop, num, dtype=None, name=None):
    def _v(v):
        return v.item() if isinstance(v, Tensor) else v
    return Tensor(torch.linspace(_v(start), _v(stop), int(_v(num)),
                                 dtype=_float(dtype), device=current_device()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    return Tensor(torch.eye(num_rows, num_columns or num_rows,
                            dtype=_float(dtype), device=current_device()))


def tril(x, diagonal=0, name=None):
    return dispatch.call("tril", lambda a: torch.tril(a, diagonal),
                         [as_tensor(x)])


def triu(x, diagonal=0, name=None):
    return dispatch.call("triu", lambda a: torch.triu(a, diagonal),
                         [as_tensor(x)])


# -------------------------------------------------------------------- random
@register("uniform", category="random", differentiable=False)
def uniform(shape, dtype="float32", min=-1.0, max=1.0, seed=0, name=None):
    """U[min, max) from the device's generator (or from ``seed`` when it
    is not 0)."""
    graph_break("paddle.uniform")
    dev = current_device()
    g = (default_generator(dev) if seed == 0 else
         torch.Generator(device=dev).manual_seed(int(seed)))
    out = torch.empty(_shape(shape), dtype=convert_dtype(dtype), device=dev)
    return Tensor(out.uniform_(min, max, generator=g))


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype or "float32", 0.0, 1.0)


@register("gaussian", category="random", differentiable=False)
def normal(mean=0.0, std=1.0, shape=None, name=None):
    """N(mean, std); Tensor mean/std broadcast, as in the JAX package."""
    graph_break("paddle.normal")
    dev = current_device()
    g = default_generator(dev)
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m, s = as_tensor(mean), as_tensor(std)
        shp = _shape(shape) if shape is not None else tuple(
            torch.broadcast_shapes(tuple(m.shape), tuple(s.shape)))
        z = torch.randn(shp, generator=g, device=dev)
        return dispatch.call("gaussian", lambda mm, ss: mm + ss * z, [m, s])
    z = torch.randn(_shape(shape or [1]), generator=g, device=dev)
    return Tensor(mean + std * z)


def randn(shape, dtype=None, name=None):
    graph_break("paddle.randn")
    dev = current_device()
    return Tensor(torch.randn(_shape(shape), dtype=_float(dtype),
                              generator=default_generator(dev), device=dev))


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


@register("randint", category="random", differentiable=False)
def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    graph_break("paddle.randint")
    dev = current_device()
    return Tensor(torch.randint(low, high, _shape(shape),
                                dtype=convert_dtype(dtype),
                                generator=default_generator(dev), device=dev))


def randperm(n, dtype="int64", name=None):
    graph_break("paddle.randperm")
    dev = current_device()
    return Tensor(torch.randperm(n, dtype=convert_dtype(dtype),
                                 generator=default_generator(dev),
                                 device=dev))


@register("one_hot", category="creation", differentiable=False)
def one_hot(x, num_classes, name=None):
    """float32 one-hot rows of integer labels."""
    return dispatch.call("one_hot", lambda a: torch.nn.functional.one_hot(
        a.long(), num_classes).float(), [as_tensor(x)])


def clone(x, name=None):
    """A copy that keeps the autograd history."""
    return dispatch.call("clone", torch.clone, [as_tensor(x)])


def assign(x, output=None):
    """Copy ``x`` into a new tensor, or into ``output``'s payload."""
    out = dispatch.call("assign", torch.clone, [as_tensor(x)])
    if output is not None:
        output._swap_payload(out._data)
        return output
    return out


# --------------------------------------------------------- the JAX tail
@register("diag", category="creation")
def diag(x, offset=0, padding_value=0, name=None):
    """A vector's diagonal matrix (``padding_value`` off the diagonal), or
    a matrix's ``offset`` diagonal."""
    def f(a):
        if a.dim() == 1:
            out = torch.diag(a, offset)
            if padding_value != 0:
                keep = torch.diag(torch.ones_like(a, dtype=torch.bool),
                                  offset)
                out = torch.where(keep, out,
                                  torch.full_like(out, padding_value))
            return out
        return torch.diagonal(a, offset).clone()
    return dispatch.call("diag", f, [as_tensor(x)])


def diagflat(x, offset=0, name=None):
    """The diagonal matrix of the flattened x."""
    return dispatch.call("diagflat", lambda a: torch.diagflat(a, offset),
                         [as_tensor(x)])


def complex(real, imag, name=None):
    """real + i imag."""
    return dispatch.call("complex", torch.complex,
                         [as_tensor(real), as_tensor(imag)])


def polar(abs, angle, name=None):
    """abs * exp(i angle)."""
    return dispatch.call("polar", torch.polar,
                         [as_tensor(abs), as_tensor(angle)])


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    """``num`` points from base**start to base**stop, evenly spaced in
    the exponent."""
    def v(a):
        return a.item() if isinstance(a, Tensor) else a
    return Tensor(torch.logspace(v(start), v(stop), int(v(num)),
                                 base=v(base), dtype=_float(dtype),
                                 device=current_device()))


def meshgrid(*args, **kwargs):
    """Coordinate grids of 1-D tensors, matrix ("ij") indexing."""
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    return list(dispatch.call("meshgrid", lambda *xs: tuple(
        m.clone() for m in torch.meshgrid(*xs, indexing="ij")),
        [as_tensor(a) for a in args]))


def tril_indices(row, col, offset=0, dtype="int64"):
    """(2, n) row and column indices of the lower triangle of a row x col
    grid."""
    return Tensor(torch.tril_indices(row, col, offset,
                                     dtype=convert_dtype(dtype),
                                     device=current_device()))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    """(2, n) row and column indices of the upper triangle."""
    return Tensor(torch.triu_indices(row, row if col is None else col,
                                     offset, dtype=convert_dtype(dtype),
                                     device=current_device()))


def _drawn(name, x, draw):
    """A random op over x's payload: the draw from its device's
    generator, outside the recording (a graph break, as every random op
    of this module)."""
    graph_break(f"paddle.{name}")
    xt = as_tensor(x)
    return Tensor(draw(xt._data, default_generator(xt._data.device)))


def bernoulli(x, name=None):
    """0/1 draws with probability x, in x's dtype."""
    return _drawn("bernoulli", x, lambda p, g: torch.bernoulli(
        p, generator=g))


def poisson(x, name=None):
    """Poisson draws of rate x, in x's dtype."""
    return _drawn("poisson", x, lambda lam, g: torch.poisson(
        lam, generator=g))


def multinomial(x, num_samples=1, replacement=False, name=None):
    """Category ids drawn from each row's (unnormalized) weights."""
    return _drawn("multinomial", x, lambda p, g: torch.multinomial(
        p, num_samples, replacement, generator=g))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    """randint of x's shape (and dtype unless ``dtype``)."""
    xt = as_tensor(x)
    return randint(low, high, tuple(xt.shape), dtype or xt.dtype)


