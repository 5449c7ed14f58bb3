"""Linear-algebra ops (counterpart of part of ``paddle_tpu/ops/linalg.py``):
the products (``matmul``, ``mm``, ``bmm``, ``dot``, ``einsum``), ``t``,
``norm``, ``inverse``, ``cholesky`` and ``trace``, each a plain torch body
behind ``dispatch.call``. The rest of the JAX file is still to port
(ROADMAP).

``matmul_body`` is also the port's torch-level ``F.matmul``: one body
for both entries.
"""
from __future__ import annotations

import torch

from ..core import dispatch
from ..core.tensor import Tensor, as_tensor
from .registry import register

__all__ = ["matmul", "mm", "bmm", "dot", "einsum", "t", "norm", "inverse",
           "cholesky", "trace"]


def _t(x):
    return x if isinstance(x, Tensor) else as_tensor(x)


def matmul_body(x: torch.Tensor, y: torch.Tensor, transpose_x: bool = False,
                transpose_y: bool = False) -> torch.Tensor:
    """Batched product with broadcasting; ``transpose_x``/``transpose_y``
    swap the last two dims of an operand of two dims or more. Mixed
    dtypes promote, as ``jnp.matmul`` promotes them."""
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    dt = torch.promote_types(x.dtype, y.dtype)
    return torch.matmul(x.to(dt), y.to(dt))


@register("matmul", category="linalg")
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """Batched matrix product (paddle.matmul)."""
    return dispatch.call("matmul", matmul_body, [_t(x), _t(y)],
                         {"transpose_x": transpose_x,
                          "transpose_y": transpose_y})


def mm(x, y, name=None):
    return matmul(x, y)


def bmm(x, y, name=None):
    return dispatch.call("bmm", torch.bmm, [_t(x), _t(y)])


@register("dot", category="linalg")
def dot(x, y, name=None):
    """Dot product over the last axis (batched for 2-D inputs)."""
    return dispatch.call("dot", lambda a, b: (a * b).sum(-1), [_t(x), _t(y)])


@register("einsum", category="linalg")
def einsum(equation, *operands):
    return dispatch.call("einsum", lambda *xs: torch.einsum(equation, *xs),
                         [_t(o) for o in operands])


def t(x, name=None):
    """Transpose of a tensor of at most 2 dims."""
    xt = _t(x)
    if xt.ndim < 2:
        return xt
    return dispatch.call("t", lambda a: a.t(), [xt])


@register("p_norm", category="linalg")
def norm(x, p=None, axis=None, keepdim=False, name=None):
    """Frobenius (default), nuclear, inf/-inf or p-norm, over ``axis`` or
    the whole tensor."""
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis

    def f(a):
        if p is None or p == "fro":
            if ax is None:
                return torch.sqrt(torch.sum(a * a))
            return torch.linalg.norm(a, dim=ax, keepdim=keepdim)
        if p == "nuc":
            return torch.linalg.matrix_norm(a, "nuc", dim=ax or (-2, -1),
                                            keepdim=keepdim)
        v = a.reshape(-1) if ax is None else a
        return torch.linalg.vector_norm(v, float(p), dim=ax,
                                        keepdim=keepdim and ax is not None)
    return dispatch.call("p_norm", f, [_t(x)])


def inverse(x, name=None):
    return dispatch.call("inverse", torch.linalg.inv, [_t(x)])


def cholesky(x, upper=False, name=None):
    return dispatch.call("cholesky", lambda a: torch.linalg.cholesky(
        a, upper=upper), [_t(x)])


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return dispatch.call("trace", lambda a: torch.diagonal(
        a, offset, axis1, axis2).sum(-1), [_t(x)])
