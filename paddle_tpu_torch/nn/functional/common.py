"""Linear, matmul, dropout and embedding (counterparts of ``linear``,
``dropout`` and ``embedding`` in ``paddle_tpu/nn/functional/common.py``
and of ``matmul`` in ``paddle_tpu/ops/linalg.py``).

Each entry takes two kinds of input. Called on Paddle ``Tensor``s (the
Paddle API, ``import paddle_tpu_torch as paddle``) it is one op through
``core.dispatch.call`` with the JAX package's semantics. Called on
``torch.Tensor``s (the port's torch-level models and the fusion pass's
traced calls) it runs as the torch-level function it always was. The
one difference of layout: ``linear`` on Paddle Tensors takes Paddle's
(in, out) weight, and on torch.Tensors torch's ``nn.Linear`` (out, in)
weight; the Paddle entry hands the torch body ``weight.t()``, a view.
Both products cast their inputs for amp (``amp_cast``, white list).

The JAX package draws its dropout mask from a global key. The
torch-level dropout draws it from the ``torch.Generator`` the caller
hands in and raises without one; the Paddle entry draws from the
device's Paddle-API generator (``core.generator.default_generator``).
Neither draws from torch's global RNG.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch.nn import functional as TF

from ...amp.state import amp_cast
from ...core import dispatch
from ...core.generator import default_generator
from ...core.tensor import Tensor, as_tensor
from ...ops.linalg import matmul as _paddle_matmul, matmul_body


def _tensors(*xs):
    """The Paddle Tensors of ``xs`` (non-Tensor data made Tensors), Nones
    dropped."""
    return [x if isinstance(x, Tensor) else as_tensor(x)
            for x in xs if x is not None]


def linear(x, weight, bias=None, name=None):
    """x W + b. On Paddle Tensors W is (in, out), as in the JAX package;
    on torch.Tensors W is (out, in) (x W^T + b), as in ``torch.nn.Linear``.
    The weight and bias are cast to x's dtype, as the JAX package casts
    them."""
    if isinstance(x, Tensor):
        return dispatch.call(
            "linear", lambda a, w, *b: linear(a, w.t(), *b),
            _tensors(x, weight, bias))
    x, weight, bias = amp_cast("linear", x, weight, bias)
    return TF.linear(x, weight.to(x.dtype),
                     None if bias is None else bias.to(x.dtype))


def matmul(x, y, transpose_x: bool = False, transpose_y: bool = False,
           name=None):
    """Batched product with broadcasting (``ops.linalg.matmul_body``);
    ``transpose_x``/``transpose_y`` swap the last two dims of an operand
    of two dims or more. Mixed dtypes promote, as ``jnp.matmul`` promotes
    them. The same layout on Paddle Tensors and torch.Tensors."""
    if isinstance(x, Tensor) or isinstance(y, Tensor):
        return _paddle_matmul(x, y, transpose_x, transpose_y)
    x, y = amp_cast("matmul", x, y)
    return matmul_body(x, y, transpose_x, transpose_y)


def dropout(x, p: float = 0.5,
            axis: Optional[Union[int, Sequence[int]]] = None,
            training: bool = True, mode: str = "upscale_in_train",
            name=None, generator: Optional[torch.Generator] = None):
    """Zero elements with probability ``p`` while training, rescaling the
    survivors by 1/(1-p) (``mode="upscale_in_train"``) or scaling by
    (1-p) at inference (``"downscale_in_infer"``). ``axis`` shares one
    draw along the other dims. The mask comes from ``generator`` (on x's
    device); on a Paddle Tensor with no generator, from the device's
    Paddle-API generator."""
    if isinstance(x, Tensor):
        if not training or p == 0:
            if mode == "downscale_in_infer" and not training:
                return dispatch.call("dropout_scale", lambda a: a * (1 - p),
                                     [x])
            return x
        g = generator or default_generator(x._data.device)
        return dispatch.call("dropout", lambda a: dropout(
            a, p, axis, training, mode, generator=g), [x])
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout: unknown mode {mode!r}")
    if not training or p == 0:
        if mode == "downscale_in_infer" and not training:
            return x * (1 - p)
        return x
    if p == 1:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout: pass a torch.Generator; the port never "
                         "draws from torch's global RNG")
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        axes = [a % x.dim() for a in axes]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = torch.rand(shape, generator=generator, device=x.device) < 1 - p
    y = torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))
    if mode == "upscale_in_train":
        y = y / (1 - p)
    return y


def embedding(x, weight, padding_idx: Optional[int] = None, sparse=False,
              name=None):
    """Rows of ``weight`` (V, H) at the integer ids ``x``; rows of
    ``padding_idx`` give zeros (and no gradient). The ids take no
    gradient."""
    if isinstance(x, Tensor):
        return dispatch.call("embedding", lambda ids, w: embedding(
            ids, w, padding_idx), _tensors(x, weight),
            differentiable_mask=[False, True])
    out = TF.embedding(x.long(), weight)
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx)[..., None], 0.0)
    return out


__all__ = ["linear", "matmul", "dropout", "embedding"]
