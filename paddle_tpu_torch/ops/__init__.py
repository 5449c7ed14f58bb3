"""The op layer: Paddle-API tensor functions and the Tensor methods
(counterpart of ``paddle_tpu/ops/__init__.py``), and beside them
``ops/cuda``, the hand-written kernels of the port, each with its plain
PyTorch version.

Every op here is a plain torch body behind ``core.dispatch.call``; this
module attaches the operators and methods to ``Tensor``, as the JAX
package's does (and the reference's monkey-patch of tensor methods),
the in-place family (``ops/inplace.py``) among them. ``control_flow``
(``cond``, ``while_loop``, ``case``, ``switch_case``) is reached as
``static.nn``'s; ``ops.cond``, as in the JAX package, is linalg's
condition number.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core import dispatch
from ..core.tensor import Tensor, as_tensor
from . import (control_flow, creation, linalg, manipulation, math, reduction,
               search)
from .registry import OPS, op_names, register

from .math import *          # noqa: F401,F403
from .creation import *      # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .reduction import *     # noqa: F401,F403
from .linalg import *        # noqa: F401,F403
from .search import *        # noqa: F401,F403
from . import inplace, tail  # noqa: E402  (after the base ops)
from .inplace import *       # noqa: F401,F403
from .tail import *          # noqa: F401,F403

__all__ = sorted(set(math.__all__ + creation.__all__ + manipulation.__all__
                     + reduction.__all__ + linalg.__all__ + search.__all__
                     + inplace.__all__ + tail.__all__))


# ---------------------------------------------------------------- indexing
def _norm_index(idx, device):
    """Tensors (integer ones as int64) and numpy arrays in an index
    expression -> torch tensors on ``device``."""
    def conv(i):
        if isinstance(i, Tensor):
            i = i._data
        elif isinstance(i, np.ndarray):
            i = torch.from_numpy(i).to(device)
        if isinstance(i, torch.Tensor) and i.dtype not in (torch.bool,
                                                           torch.int64):
            i = i.long()
        return i
    if isinstance(idx, tuple):
        return tuple(conv(i) for i in idx)
    return conv(idx)


def _positive_steps(a: torch.Tensor, idx):
    """(a with some dims flipped, idx with positive steps): torch slices
    take no negative step, so a dim sliced backwards is flipped and its
    slice mirrored."""
    # the star imports above shadow any/sum/slice: builtins only here
    items = list(idx) if isinstance(idx, tuple) else [idx]
    if not builtins.any(isinstance(i, builtins.slice) and (i.step or 1) < 0
                        for i in items):
        return a, idx
    used = builtins.sum(i.dim() if isinstance(i, torch.Tensor) and i.dtype ==
               torch.bool else 0 if i is None or i is Ellipsis else 1
               for i in items)
    dim, flips = 0, []
    for k, it in enumerate(items):
        if it is Ellipsis:
            dim += a.dim() - used
        elif isinstance(it, builtins.slice):
            n = a.shape[dim]
            if (it.step or 1) < 0:
                start, stop, step = it.indices(n)
                items[k] = builtins.slice(n - 1 - start, n - 1 - stop, -step)
                flips.append(dim)
            dim += 1
        elif isinstance(it, torch.Tensor) and it.dtype == torch.bool:
            dim += it.dim()
        elif it is not None:
            dim += 1
    return a.flip(flips), tuple(items)


def _index_inputs(idx):
    """(the Tensors in an index expression, the expression with each of
    them replaced by its position among them): the Tensors are inputs of
    the op, so a program ``to_static`` replays indexes by the call's."""
    items = idx if isinstance(idx, tuple) else (idx,)
    tensors = [i for i in items if isinstance(i, Tensor)]
    slots = iter(range(len(tensors)))
    shape = tuple(_Slot(next(slots)) if isinstance(i, Tensor) else i
                  for i in items)
    return tensors, (shape if isinstance(idx, tuple) else shape[0])


class _Slot:
    __slots__ = ("k",)

    def __init__(self, k):
        self.k = k


def _fill_slots(shape, payloads, device):
    items = shape if isinstance(shape, tuple) else (shape,)
    filled = tuple(payloads[i.k] if isinstance(i, _Slot) else i
                   for i in items)
    return _norm_index(filled if isinstance(shape, tuple) else filled[0],
                       device)


def _getitem(self, idx):
    """``t[idx]``: ints, slices (negative steps too), ellipsis, None,
    integer and boolean tensors (a boolean mask selects a 1-D result), as
    one ``getitem`` op (index Tensors are its inputs, with no
    gradient)."""
    tensors, shape = _index_inputs(idx)

    def f(a, *index):
        a, i = _positive_steps(a, _fill_slots(shape, index, a.device))
        return a[i]
    return dispatch.call("getitem", f, [self] + tensors,
                         differentiable_mask=[True] + [False] * len(tensors)
                         if tensors else None)


register("getitem", category="indexing")(_getitem)


def _setitem(self, idx, value):
    """``t[idx] = value``: the written copy becomes t's payload (the JAX
    package's ``.at[idx].set``), differentiable in both."""
    tensors, shape = _index_inputs(idx)
    vt = value if isinstance(value, Tensor) else as_tensor(
        value, device=self._data.device)

    def f(a, v, *index):
        out = a.clone()
        out[_fill_slots(shape, index, a.device)] = v.to(a.dtype)
        return out
    out = dispatch.call("setitem", f, [self, vt] + tensors,
                        differentiable_mask=[True, True]
                        + [False] * len(tensors) if tensors else None)
    self._swap_payload(out._data)
    return self


register("setitem", category="indexing")(_setitem)


def _fill(self, v):
    return self.set_value(torch.full(tuple(self.shape), v,
                                     dtype=self.dtype, device=self._data.device))


_BINARY_OPERATORS = {
    "__add__": math.add, "__radd__": lambda a, b: math.add(b, a),
    "__sub__": math.subtract, "__rsub__": lambda a, b: math.subtract(b, a),
    "__mul__": math.multiply, "__rmul__": lambda a, b: math.multiply(b, a),
    "__truediv__": math.divide,
    "__rtruediv__": lambda a, b: math.divide(b, a),
    "__floordiv__": math.floor_divide,
    "__rfloordiv__": lambda a, b: math.floor_divide(b, a),
    "__mod__": math.mod, "__rmod__": lambda a, b: math.mod(b, a),
    "__pow__": math.pow, "__rpow__": lambda a, b: math.pow(b, a),
    "__matmul__": linalg.matmul,
    "__rmatmul__": lambda a, b: linalg.matmul(b, a),
    "__eq__": math.equal, "__ne__": math.not_equal,
    "__lt__": math.less_than, "__le__": math.less_equal,
    "__gt__": math.greater_than, "__ge__": math.greater_equal,
    "__and__": math.bitwise_and, "__or__": math.bitwise_or,
    "__xor__": math.bitwise_xor,
}


def _attach_methods():
    for name, fn in _BINARY_OPERATORS.items():
        setattr(Tensor, name, (lambda f: lambda self, other: f(self, other))(fn))
    Tensor.__neg__ = lambda self: math.neg(self)
    Tensor.__abs__ = lambda self: math.abs(self)
    Tensor.__invert__ = lambda self: math.logical_not(self)
    Tensor.__getitem__ = _getitem
    Tensor.__setitem__ = _setitem
    Tensor.__hash__ = object.__hash__  # __eq__ override would kill hashing

    methods = {
        # math
        "add": math.add, "subtract": math.subtract,
        "multiply": math.multiply, "divide": math.divide,
        "floor_divide": math.floor_divide, "mod": math.mod,
        "remainder": math.mod, "pow": math.pow, "maximum": math.maximum,
        "minimum": math.minimum, "exp": math.exp, "log": math.log,
        "log2": math.log2, "log10": math.log10, "log1p": math.log1p,
        "sqrt": math.sqrt, "rsqrt": math.rsqrt, "square": math.square,
        "abs": math.abs, "neg": math.neg, "sign": math.sign,
        "floor": math.floor, "ceil": math.ceil, "round": math.round,
        "trunc": math.trunc, "reciprocal": math.reciprocal, "sin": math.sin,
        "cos": math.cos, "tan": math.tan, "asin": math.asin,
        "acos": math.acos, "atan": math.atan, "sinh": math.sinh,
        "cosh": math.cosh, "tanh": math.tanh, "erf": math.erf,
        "sigmoid": math.sigmoid, "scale": math.scale, "clip": math.clip,
        "lerp": math.lerp, "cast": math.cast, "astype": math.cast,
        "isnan": math.isnan, "isinf": math.isinf,
        "isfinite": math.isfinite, "equal": math.equal,
        "not_equal": math.not_equal, "less_than": math.less_than,
        "less_equal": math.less_equal, "greater_than": math.greater_than,
        "greater_equal": math.greater_equal,
        "logical_and": math.logical_and, "logical_or": math.logical_or,
        "logical_not": math.logical_not, "logical_xor": math.logical_xor,
        "isclose": math.isclose, "allclose": math.allclose,
        "equal_all": math.equal_all, "nan_to_num": math.nan_to_num,
        "real": math.real, "imag": math.imag, "conj": math.conj,
        "angle": math.angle,
        # reduction
        "sum": reduction.sum, "mean": reduction.mean, "max": reduction.max,
        "min": reduction.min, "prod": reduction.prod, "any": reduction.any,
        "all": reduction.all, "std": reduction.std, "var": reduction.var,
        "logsumexp": reduction.logsumexp, "cumsum": reduction.cumsum,
        "cumprod": reduction.cumprod, "amax": reduction.amax,
        "amin": reduction.amin, "count_nonzero": reduction.count_nonzero,
        "median": reduction.median,
        # manipulation
        "reshape": manipulation.reshape, "reshape_": manipulation.reshape_,
        "flatten": manipulation.flatten, "squeeze": manipulation.squeeze,
        "squeeze_": manipulation.squeeze_,
        "unsqueeze": manipulation.unsqueeze,
        "unsqueeze_": manipulation.unsqueeze_,
        "transpose": manipulation.transpose, "tile": manipulation.tile,
        "expand": manipulation.expand, "expand_as": manipulation.expand_as,
        "broadcast_to": manipulation.broadcast_to,
        "flip": manipulation.flip, "roll": manipulation.roll,
        "gather": manipulation.gather, "gather_nd": manipulation.gather_nd,
        "scatter": manipulation.scatter,
        "index_select": manipulation.index_select,
        "masked_select": manipulation.masked_select,
        "masked_fill": manipulation.masked_fill,
        "split": manipulation.split, "chunk": manipulation.chunk,
        "unbind": manipulation.unbind,
        "take_along_axis": manipulation.take_along_axis,
        "put_along_axis": manipulation.put_along_axis,
        "repeat_interleave": manipulation.repeat_interleave,
        "diagonal": manipulation.diagonal, "moveaxis": manipulation.moveaxis,
        "view": manipulation.view, "view_as": manipulation.view_as,
        "scatter_nd_add": manipulation.scatter_nd_add,
        "numel_t": manipulation.numel,
        # linalg
        "matmul": linalg.matmul, "mm": linalg.mm, "bmm": linalg.bmm,
        "dot": linalg.dot, "norm": linalg.norm, "t": linalg.t,
        "trace": linalg.trace, "inverse": linalg.inverse,
        "cholesky": linalg.cholesky, "dist": linalg.dist,
        "inner": linalg.inner, "outer": linalg.outer, "cross": linalg.cross,
        "matrix_power": linalg.matrix_power,
        # search
        "argmax": search.argmax, "argmin": search.argmin,
        "argsort": search.argsort, "sort": search.sort, "topk": search.topk,
        "where": search.where, "nonzero": search.nonzero,
        "unique": search.unique, "kthvalue": search.kthvalue,
        "bucketize": search.bucketize,
        # creation-ish
        "clone": creation.clone, "fill_": _fill,
        "zero_": lambda self: _fill(self, 0),
    }
    for name, fn in methods.items():
        setattr(Tensor, name, fn)

    # the in-place family (ops/inplace.py): x.abs_(), x.add_(y), ...
    for nm in inplace.__all__ + list(inplace.SUGAR):
        setattr(Tensor, nm, getattr(inplace, nm))


_attach_methods()


def _register_all():
    from .registry import register_module
    for mod, cat in ((math, "math"), (creation, "creation"),
                     (manipulation, "manipulation"),
                     (reduction, "reduction"), (linalg, "linalg"),
                     (search, "search")):
        register_module(mod, cat)

    def rotary_embedding(x, theta=10000.0, pos_offset=0):
        """RoPE on (B, S, H, D) activations: ``models.llama``'s (imported
        on first use, as the JAX package's forwarder does)."""
        from ..models.llama import rotary_embedding as _impl
        return _impl(x, theta=theta, pos_offset=pos_offset)

    register("rotary_embedding", category="attention")(rotary_embedding)


_register_all()
