"""Parameter: a trainable Tensor, and ParamAttr (counterpart of
``paddle_tpu/nn/parameter.py``).

A ``Parameter``'s payload is a leaf ``torch.Tensor``; a trainable one
requires grad. Optimizers update that leaf in place, so it keeps its
identity for the parameter's life (``Layer.to`` swaps it for a cast
copy, before an optimizer is built).
"""
from __future__ import annotations

import copy
import itertools
from typing import Optional

import torch

from ..core import dtype as dtypes
from ..core.tensor import Tensor

_param_counter = itertools.count()


class ParamAttr:
    def __init__(self, name: Optional[str] = None, initializer=None,
                 learning_rate: float = 1.0, regularizer=None,
                 trainable: bool = True, need_clip: bool = True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if attr is False:
            return None
        # an initializer instance used directly as attr
        return ParamAttr(initializer=attr)


class Parameter(Tensor):
    def __init__(self, data: torch.Tensor, *, trainable: bool = True,
                 name: Optional[str] = None, optimize_attr=None,
                 regularizer=None, need_clip: bool = True):
        super().__init__(data.detach(), stop_gradient=not trainable,
                         name=name or f"param_{next(_param_counter)}",
                         persistable=True)
        self.trainable = trainable
        self.optimize_attr = optimize_attr or {"learning_rate": 1.0}
        self.regularizer = regularizer
        self.need_clip = need_clip
        self.is_distributed = False

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()

    def __deepcopy__(self, memo):
        """A copy with its own payload and a fresh name (optimizers key
        their state by name)."""
        new = type(self).__new__(type(self))
        memo[id(self)] = new
        for k, v in self.__dict__.items():
            new.__dict__[k] = copy.deepcopy(v, memo)
        new.name = f"param_{next(_param_counter)}"
        return new


def create_parameter(shape, dtype=dtypes.float32, attr=None, is_bias=False,
                     default_initializer=None) -> Optional[Parameter]:
    """A Parameter initialized by ``attr``'s initializer, else
    ``default_initializer``, else zeros for a bias and XavierNormal
    otherwise, on the current device."""
    from . import initializer as I

    attr = ParamAttr._to_attr(attr)
    if attr is None:
        return None
    init = attr.initializer or default_initializer
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierNormal()
    p = Parameter(init(shape, dtypes.convert_dtype(dtype)),
                  trainable=attr.trainable, name=attr.name)
    p.optimize_attr = {"learning_rate": attr.learning_rate}
    p.regularizer = attr.regularizer
    p.need_clip = attr.need_clip
    return p
