"""Higher-order functional autograd: jacobian / hessian / jvp / vjp
(counterpart of ``paddle_tpu/autograd/functional.py``).

Reference contracts: ``python/paddle/autograd/autograd.py`` (``jacobian``
:450 / ``hessian`` :544 over computed ``ys``/``xs`` with ``batch_axis``,
returning lazily evaluated ``Jacobian``/``Hessian`` views) and
``python/paddle/incubate/autograd/functional.py`` (``vjp`` :22, ``jvp``
:80, forward mode from double reverse, ``_double_backward_trick`` :143).

Rows come from ``paddle.grad`` with ``retain_graph`` over torch's graph
and are cached per row; the jvp is the double-backward construction.
``vjp`` and ``jvp`` call ``func`` on fresh leaves that share the inputs'
values (``_leaves``), so the callers' tensors and their
``stop_gradient`` flags are never touched: torch cannot differentiate a
leaf whose ``requires_grad`` was switched off again after use, as the
JAX package's restore of the flags would do.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.tensor import Tensor

__all__ = ["jacobian", "hessian", "Jacobian", "Hessian", "vjp", "jvp"]


def _as_tensors(xs):
    return (xs,) if isinstance(xs, Tensor) else tuple(xs)


def _leaves(xs_t):
    """Differentiable leaves holding the values of ``xs_t``."""
    return tuple(Tensor(x._data.detach(), stop_gradient=False) for x in xs_t)


def _flat_nonbatch(t: Tensor, batch_axis: Optional[int]):
    """(B?, N) view of t with batch axis (if any) moved to front."""
    from .. import ops
    if batch_axis is None:
        return ops.reshape(t, [-1])
    if batch_axis != 0:
        raise ValueError(
            f"batch_axis must be None or 0 (reference contract), got "
            f"{batch_axis}")
    return ops.reshape(t, [t.shape[0], -1])


class Jacobian:
    """Lazy d(ys)/d(xs) for ONE (ys, xs) pair.

    Shape: (M, N) without batch, (B, M, N) with ``batch_axis=0`` where
    M/N are the flattened non-batch sizes of ys/xs. Rows are computed on
    first access and cached; ``[:]`` materializes everything.
    """

    def __init__(self, ys: Tensor, xs: Tensor,
                 batch_axis: Optional[int] = None, _create_graph=False):
        self._ys = ys
        self._xs = xs
        self._batch_axis = batch_axis
        self._create_graph = _create_graph
        self._yflat = _flat_nonbatch(ys, batch_axis)
        m = self._yflat.shape[-1]
        if batch_axis is None:
            n = int(np.prod(xs.shape)) if xs.shape else 1
            self.shape = (m, n)
        else:
            b = xs.shape[0]
            n = int(np.prod(xs.shape[1:])) if xs.shape[1:] else 1
            self.shape = (b, m, n)
        self._rows = {}

    def _row(self, i: int) -> Tensor:
        """d yflat[..., i] / d xs, flattened like xs (batch leading)."""
        if i not in self._rows:
            from .. import ops
            from . import grad as pgrad
            if self._batch_axis is None:
                y_i = self._yflat[i]
            else:
                y_i = self._yflat[:, i].sum()  # batch rows are independent
            (g,) = pgrad(y_i, [self._xs], retain_graph=True,
                         create_graph=self._create_graph,
                         allow_unused=True)
            if g is None:
                g = ops.zeros_like(self._xs)
            self._rows[i] = _flat_nonbatch(g, self._batch_axis)
        return self._rows[i]

    def _materialize(self) -> Tensor:
        from .. import ops
        m = self.shape[0] if self._batch_axis is None else self.shape[1]
        rows = [self._row(i) for i in range(m)]
        stacked = ops.stack(rows, axis=0 if self._batch_axis is None else 1)
        return stacked

    def __getitem__(self, idx):
        # single-row access stays O(1 backward pass) in the unbatched
        # case (the first axis IS the row axis there); everything else
        # materializes
        if isinstance(idx, int) and self._batch_axis is None:
            return self._row(idx)
        full = self._materialize()
        return full[idx]

    def __array__(self, dtype=None):
        arr = np.asarray(self._materialize().numpy())
        return arr.astype(dtype) if dtype is not None else arr

    def numpy(self):
        return self.__array__()

    def __repr__(self):
        return f"Jacobian(shape={self.shape})"


class Hessian(Jacobian):
    """d²(ys)/d(xs)² for scalar (or per-batch scalar) ``ys``: the
    Jacobian of the create_graph gradient."""

    def __init__(self, ys: Tensor, xs: Tensor,
                 batch_axis: Optional[int] = None):
        from . import grad as pgrad
        if batch_axis is None:
            scalar = ys.sum() if ys.shape else ys
        else:
            scalar = ys.sum()
        (g,) = pgrad(scalar, [xs], create_graph=True, retain_graph=True)
        super().__init__(g, xs, batch_axis)


def _nest(ys, xs, batch_axis, cls):
    ys_t = _as_tensors(ys)
    xs_t = _as_tensors(xs)
    rows = [tuple(cls(y, x, batch_axis) for x in xs_t) for y in ys_t]
    # reference nesting: single/one-level/two-level mirroring input nests
    if isinstance(ys, Tensor) and isinstance(xs, Tensor):
        return rows[0][0]
    if isinstance(ys, Tensor):
        return rows[0]
    if isinstance(xs, Tensor):
        return tuple(r[0] for r in rows)
    return tuple(rows)


def jacobian(ys, xs, batch_axis: Optional[int] = None):
    """paddle.autograd.jacobian (reference autograd.py:450)."""
    return _nest(ys, xs, batch_axis, Jacobian)


def hessian(ys, xs, batch_axis: Optional[int] = None):
    """paddle.autograd.hessian (reference autograd.py:544). ``ys`` must
    be scalar (or shape [B] with ``batch_axis=0``). A tuple ``xs``
    returns the reference's tuple-of-tuples: ``H[i][j]`` is the
    d²ys/∂xs[i]∂xs[j] block (cross-partials included)."""
    if isinstance(ys, (tuple, list)):
        raise ValueError("hessian expects a single (scalar) ys tensor")
    nb = ys.shape if batch_axis is None else ys.shape[1:]
    if int(np.prod(nb)) != 1:
        raise ValueError(
            f"hessian needs scalar ys (per batch), got shape {ys.shape}")
    if isinstance(xs, Tensor):
        return Hessian(ys, xs, batch_axis)
    from . import grad as pgrad
    xs_t = _as_tensors(xs)
    scalar = ys.sum() if ys.shape else ys
    firsts = pgrad(scalar, list(xs_t), create_graph=True,
                   retain_graph=True)
    return tuple(
        tuple(Jacobian(g_i, x_j, batch_axis) for x_j in xs_t)
        for g_i in firsts)


# ------------------------------------------------------- functional pair
def vjp(func, xs, v=None):
    """(ys, vjp_result): reverse-mode product (reference
    incubate/autograd/functional.py:22). Inputs unused by ``func`` get
    zero cotangents; the callers' tensors are not touched."""
    from . import grad as pgrad
    from .. import ops
    xs_t = _leaves(_as_tensors(xs))
    ys = func(*xs_t)
    ys_t = _as_tensors(ys)
    if v is None:
        v_t = [ops.ones_like(y) for y in ys_t]
    else:
        v_t = list(_as_tensors(v))
    grads = pgrad(list(ys_t), list(xs_t), grad_outputs=v_t,
                  retain_graph=True, allow_unused=True)
    grads = [g if g is not None else ops.zeros_like(x)
             for g, x in zip(grads, xs_t)]
    out = grads[0] if isinstance(xs, Tensor) else tuple(grads)
    return ys, out


def jvp(func, xs, v=None):
    """(ys, jvp_result): forward-mode product via the double-backward
    trick (reference functional.py:80/:143 — jvp = ∂/∂u [vjp(u)·v] where
    u is a zero cotangent with grad enabled)."""
    from . import grad as pgrad
    from .. import ops
    xs_t = _leaves(_as_tensors(xs))
    ys = func(*xs_t)
    ys_t = _as_tensors(ys)
    if v is None:
        v_t = [ops.ones_like(x) for x in xs_t]
    else:
        v_t = list(_as_tensors(v))
    # u: zero cotangents, differentiable (reference _zeros_like_with_grad)
    u = []
    for y in ys_t:
        z = ops.zeros_like(y)
        z.stop_gradient = False
        u.append(z)
    first = pgrad(list(ys_t), list(xs_t), grad_outputs=u,
                  create_graph=True, retain_graph=True, allow_unused=True)
    first = [f if f is not None else ops.zeros_like(x)
             for f, x in zip(first, xs_t)]
    second = pgrad(first, u, grad_outputs=v_t, retain_graph=True,
                   allow_unused=True)
    second = [s if s is not None else ops.zeros_like(y)
              for s, y in zip(second, ys_t)]
    out = second[0] if isinstance(ys, Tensor) else tuple(second)
    return ys, out
