"""User-facing autograd API (counterpart of ``paddle_tpu/autograd/``):
``backward``, ``grad``, ``PyLayer`` and the functional transforms, over
torch autograd (``engine.py``)."""
from __future__ import annotations

from typing import Sequence

from ..core.dispatch import (enable_grad, grad_enabled, no_grad,
                             set_grad_enabled_ctx as set_grad_enabled)
from ..core.tensor import Tensor
from .engine import run_backward
from .functional import Hessian, Jacobian, hessian, jacobian
from .pylayer import PyLayer, PyLayerContext


def is_grad_enabled() -> bool:
    return grad_enabled()


def backward(tensors: Sequence[Tensor], grad_tensors=None,
             retain_graph=False):
    """paddle.autograd.backward: accumulate into the leaves' ``.grad``."""
    if isinstance(tensors, Tensor):
        tensors = [tensors]
    if grad_tensors is not None and isinstance(grad_tensors, Tensor):
        grad_tensors = [grad_tensors]
    run_backward(tensors, grad_tensors, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad: the gradients of ``outputs`` with respect to
    ``inputs``, without touching any ``.grad``; ``create_graph`` records
    them for a further backward."""
    outs = [outputs] if isinstance(outputs, Tensor) else list(outputs)
    ins = [inputs] if isinstance(inputs, Tensor) else list(inputs)
    gouts = grad_outputs
    if gouts is not None and isinstance(gouts, Tensor):
        gouts = [gouts]
    if retain_graph is None:
        retain_graph = create_graph
    return run_backward(outs, gouts, retain_graph=retain_graph,
                        create_graph=create_graph, inputs=ins,
                        allow_unused=allow_unused)


__all__ = ["backward", "grad", "no_grad", "enable_grad", "set_grad_enabled",
           "is_grad_enabled", "PyLayer", "PyLayerContext", "jacobian",
           "hessian", "Jacobian", "Hessian"]
