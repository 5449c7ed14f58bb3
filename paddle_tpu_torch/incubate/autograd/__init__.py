"""paddle.incubate.autograd (counterpart of
``paddle_tpu/incubate/autograd/__init__.py``): ``vjp``, ``jvp`` and the
callable-first ``Jacobian``/``Hessian``.

Reference: ``python/paddle/incubate/autograd/functional.py`` (vjp :22,
jvp :80, Jacobian :170, Hessian :257). ``func`` runs on fresh leaves
holding the inputs' values (``autograd.functional._leaves``), so the
graph links back to them and the callers' tensors are not touched. The
JAX package's ``enable_prim`` switches are not ported (the prim rewrite
is XLA's job there; torch has no counterpart).
"""
from ...autograd import functional as _fn
from ...autograd.functional import jvp, vjp
from ...core.tensor import Tensor as _Tensor


def _traced(func, xs, batched, build):
    xs_t = (xs,) if isinstance(xs, _Tensor) else tuple(xs)
    leaves = _fn._leaves(xs_t)
    ys = func(*leaves)
    return build(ys, leaves[0] if isinstance(xs, _Tensor) else leaves,
                 0 if batched else None)


class Jacobian:
    """Lazy Jacobian of ``func`` at ``xs`` (reference Jacobian :170; the
    callable-first signature, unlike ``paddle.autograd.jacobian``)."""

    def __init__(self, func, xs, is_batched: bool = False):
        self._inner = _traced(func, xs, is_batched, _fn.jacobian)

    @property
    def shape(self):
        inner = self._inner
        return (inner.shape if not isinstance(inner, tuple)
                else tuple(j.shape for j in inner))

    def __getitem__(self, idx):
        inner = self._inner
        if isinstance(inner, tuple):
            # reference: multiple xs concatenate along the input axis
            from ... import ops
            return ops.concat([j[:] for j in inner], axis=-1)[idx]
        return inner[idx]

    def numpy(self):
        return self[:].numpy()


class Hessian(Jacobian):
    """Lazy Hessian of scalar-valued ``func`` at ``xs`` (reference
    Hessian :257)."""

    def __init__(self, func, xs, is_batched: bool = False):
        self._inner = _traced(func, xs, is_batched, _fn.hessian)

    @property
    def shape(self):
        inner = self._inner
        if not isinstance(inner, tuple):
            return inner.shape
        # flattened block matrix: (sum_N, sum_N) (+ leading batch)
        total = sum(row[0].shape[-2] for row in inner)
        return tuple(inner[0][0].shape[:-2]) + (total, total)

    def __getitem__(self, idx):
        inner = self._inner
        if isinstance(inner, tuple):
            # reference: multiple xs flatten into one block matrix
            from ... import ops
            rows = [ops.concat([blk[:] for blk in row], axis=-1)
                    for row in inner]
            return ops.concat(rows, axis=-2)[idx]
        return inner[idx]


__all__ = ["vjp", "jvp", "Jacobian", "Hessian"]
