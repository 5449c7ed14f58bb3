"""``to_static`` (counterpart of ``paddle_tpu/jit/api.py``).

The JAX package traces a function into one XLA program per input
signature; the port traces it with ``torch.fx`` into a ``GraphModule`` per
signature and runs that eagerly. The signature is the tensors' shapes,
dtypes and devices, the values of the other arguments, the modules'
``training`` flags, the amp state (``amp.auto_cast``'s level, dtype and
custom lists; each leaf of a trace runs under the state it was traced
under) and, with ``FLAGS_enable_fusion``, the fusion pass's fingerprint,
so fused and unfused traces never share an entry. With the
flag on, the graph-fusion pass (``compile/fusion``) rewrites the trace
onto the fused ops, and ``fusion_stats`` holds the pass's stats for the
last call's signature (``None`` with the flag off, as in the JAX package).

A module's parameters stay its own: the graph reads them through the
module, so an optimizer built on ``model.parameters()`` trains the traced
program. The whole callable is traced; where ``torch.fx`` cannot trace it
(data-dependent control flow), the call raises. Graph breaks (the JAX
package's SOT, ``full_graph=False``) are a later slice: the port never
falls back to eager silently.
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..amp.state import amp_state
from ..compile import fusion
from ..compile.fusion.fx import trace_program


def _describe(name: str, value):
    if isinstance(value, torch.Tensor):
        return ("tensor", tuple(value.shape), value.dtype, value.device)
    try:
        hash(value)
    except TypeError:
        raise TypeError(f"to_static: argument {name!r} is neither a tensor "
                        f"nor a hashable constant") from None
    return ("const", value)


class StaticFunction:
    """A traced callable: one ``torch.fx`` program per input signature."""

    def __init__(self, function: Callable):
        self._fn = function
        target = function.forward if isinstance(function, nn.Module) \
            else function
        self._sig = inspect.signature(target)
        variadic = [p.name for p in self._sig.parameters.values()
                    if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
        if variadic:
            raise TypeError(f"to_static: *args/**kwargs parameters "
                            f"{variadic} cannot be traced")
        self._programs: Dict[tuple, tuple] = {}
        #: the ``torch.fx.GraphModule`` the last call ran
        self.graph_module = None
        #: the fusion pass's stats of the last call's signature
        self.fusion_stats: Optional[dict] = None

    def __call__(self, *args, **kwargs):
        bound = self._sig.bind(*args, **kwargs)
        bound.apply_defaults()
        values = list(bound.arguments.values())
        fuse = fusion.enabled()
        modes = tuple(m.training for m in self._fn.modules()) \
            if isinstance(self._fn, nn.Module) else ()
        key = (fuse and fusion.fingerprint(), modes, amp_state(),
               tuple(_describe(n, v) for n, v in bound.arguments.items()))
        program = self._programs.get(key)
        if program is None:
            concrete = {n: v for n, v in bound.arguments.items()
                        if not isinstance(v, torch.Tensor)}
            program = self._programs[key] = trace_program(
                self._fn, values, concrete, fuse)
        self.graph_module, self.fusion_stats = program
        return self.graph_module(*values)


def to_static(function=None, full_graph: bool = False):
    """Capture ``function`` (a function or an ``nn.Module``) with
    ``torch.fx``; usable as a decorator. Returns a ``StaticFunction``.
    ``full_graph`` is accepted for the JAX package's signature; either way
    the whole callable is traced."""
    def decorate(fn):
        return StaticFunction(fn)
    return decorate(function) if function is not None else decorate
