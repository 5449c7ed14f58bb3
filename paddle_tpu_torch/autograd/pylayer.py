"""PyLayer: user-defined autograd functions (counterpart of
``paddle_tpu/autograd/pylayer.py``), over one ``torch.autograd.Function``.

``PyLayer.apply`` runs the subclass's ``forward(ctx, *args)`` on Paddle
Tensors with grad disabled and records one torch graph node whose
backward calls the subclass's ``backward(ctx, *grads)`` on Paddle
Tensors; it returns one gradient for each Tensor argument, in order.
Under ``no_grad`` nothing is recorded and the outputs stop gradients.
"""
from __future__ import annotations

from typing import Any, List

import torch

from ..core.tensor import Tensor, graph_break


class PyLayerContext:
    def __init__(self):
        self._saved: List[Any] = []
        self.non_differentiable = ()
        self._materialize_grads = True

    def save_for_backward(self, *tensors):
        self._saved = list(tensors)

    def saved_tensor(self):
        return self._saved

    @property
    def saved_tensors(self):
        return tuple(self._saved)

    def mark_non_differentiable(self, *tensors):
        self.non_differentiable = tensors

    def set_materialize_grads(self, value: bool):
        self._materialize_grads = value


class _Call:
    """What one ``apply`` hands its torch Function besides the payloads."""

    def __init__(self, cls, ctx, args, kwargs, tensor_pos):
        self.cls, self.ctx, self.args, self.kwargs = cls, ctx, args, kwargs
        self.tensor_pos = tensor_pos
        self.single = True


class _Function(torch.autograd.Function):
    @staticmethod
    def forward(tctx, call: _Call, *payloads):
        args = list(call.args)
        for pos, p in zip(call.tensor_pos, payloads):
            args[pos] = Tensor(p)
        outs = call.cls.forward(call.ctx, *args, **call.kwargs)
        call.single = not isinstance(outs, (tuple, list))
        out_list = [outs] if call.single else list(outs)
        tctx.call = call
        tctx.set_materialize_grads(call.ctx._materialize_grads)
        frozen = [o._data for o in call.ctx.non_differentiable
                  if isinstance(o, Tensor)]
        if frozen:
            tctx.mark_non_differentiable(*frozen)
        return tuple(o._data if isinstance(o, Tensor) else o
                     for o in out_list)

    @staticmethod
    def backward(tctx, *grads):
        call = tctx.call
        grad_ts = [None if g is None else Tensor(g) for g in grads]
        res = call.cls.backward(call.ctx, *grad_ts)
        res = list(res) if isinstance(res, (tuple, list)) else [res]
        if len(res) != len(call.tensor_pos):
            raise RuntimeError(
                f"{call.cls.__name__}.backward returned {len(res)} "
                f"gradients for {len(call.tensor_pos)} Tensor inputs")
        return (None,) + tuple(r._data if isinstance(r, Tensor) else r
                               for r in res)


class PyLayer:
    """Subclass with static ``forward(ctx, *args)`` and
    ``backward(ctx, *grads)``."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        graph_break("PyLayer.apply()")
        pos = [i for i, a in enumerate(args) if isinstance(a, Tensor)]
        call = _Call(cls, PyLayerContext(), args, kwargs, pos)
        outs = _Function.apply(call, *[args[i]._data for i in pos])
        wrapped = [Tensor(o) if isinstance(o, torch.Tensor) else o
                   for o in outs]
        return wrapped[0] if call.single else wrapped
