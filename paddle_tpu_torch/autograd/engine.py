"""The backward engine (counterpart of ``paddle_tpu/autograd/engine.py``):
torch autograd, with no tape of the port's own.

The JAX engine records one GradNode an op and walks them in reverse
topological order. The port's ops record torch's graph on their
payloads, so ``run_backward`` hands the payloads to
``torch.autograd.backward`` (accumulating into the leaves' ``.grad``) or
``torch.autograd.grad`` (the ``paddle.grad`` path, which never touches
``.grad``). A second backward through a released graph raises where a
torch node saved tensors for its backward, which is every node of a
product; the JAX engine raises for any node (ROADMAP Queue 3).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..core.tensor import Tensor, as_tensor, graph_break


def _seed(t: Tensor, g) -> Optional[torch.Tensor]:
    if g is None:
        return None
    g = g._data if isinstance(g, Tensor) else as_tensor(
        g, device=t._data.device)._data
    return g.to(t.dtype)


def run_backward(tensors: Sequence[Tensor], grad_tensors=None,
                 retain_graph: bool = False, create_graph: bool = False,
                 inputs: Optional[Sequence[Tensor]] = None,
                 allow_unused: bool = True) -> Optional[List]:
    """Backward from ``tensors`` seeded with ``grad_tensors`` (ones for a
    one-element output when None). With ``inputs``, return their
    gradients (None where unused) and leave ``.grad`` alone; otherwise
    accumulate into the leaves' ``.grad``."""
    graph_break("a backward")
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    outs, seeds = [], []
    for t, g in zip(tensors, grad_tensors):
        if inputs is None and t.stop_gradient:
            raise RuntimeError(
                f"Tensor {t.name} has stop_gradient=True; backward needs a "
                f"grad-tracked output")
        if g is None and t.size != 1:
            raise RuntimeError(
                f"grad must be provided for non-scalar output {t.name} "
                f"(shape {t.shape})")
        if not t.stop_gradient:
            outs.append(t._data)
            seeds.append(_seed(t, g))
    if inputs is None:
        torch.autograd.backward(outs, seeds, retain_graph=retain_graph,
                                create_graph=create_graph)
        return None
    live = [i for i, t in enumerate(inputs) if not t.stop_gradient]
    grads = [None] * len(inputs)
    if outs and live:
        got = torch.autograd.grad(outs, [inputs[i]._data for i in live],
                                  seeds, retain_graph=retain_graph,
                                  create_graph=create_graph,
                                  allow_unused=True)
        for i, g in zip(live, got):
            grads[i] = None if g is None else Tensor(g)
    if not allow_unused:
        for t, g in zip(inputs, grads):
            if g is None:
                raise RuntimeError(
                    f"One of the differentiated tensors ({t.name}) appears "
                    f"unused; pass allow_unused=True to get None for it")
    return grads
