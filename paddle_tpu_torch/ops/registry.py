"""Declarative op registry (counterpart of ``paddle_tpu/ops/registry.py``).

An ``OpDef`` records a Paddle-API op's name, category, function and
analytical cost model (``cost_fn``, which
``observability.perf.costmodel.attach_cost_models`` fills in). The JAX
package's ``spmd_rule`` field waits for the port of ``distributed/spmd``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional


@dataclass
class OpDef:
    name: str
    category: str = "misc"
    lowering: Optional[Callable] = None
    differentiable: bool = True
    doc: str = ""
    #: analytical cost model ``cost_fn(input_shapes, input_dtypes, attrs,
    #: output_shapes) -> observability.perf.costmodel.OpCost``, attached
    #: by ``costmodel.attach_cost_models()`` (per-op-class formulas) or by
    #: a ``register(..., cost_fn=...)`` site; None: no model (the perf
    #: layer falls back to the op's category)
    cost_fn: Optional[Callable] = None


OPS: Dict[str, OpDef] = {}


def register(name: str, category: str = "misc", differentiable: bool = True,
             cost_fn: Optional[Callable] = None):
    """Decorator registering a user-facing op function."""

    def deco(fn):
        OPS[name] = OpDef(name=name, category=category, lowering=fn,
                          differentiable=differentiable,
                          doc=(fn.__doc__ or ""), cost_fn=cost_fn)
        return fn

    return deco


def register_module(module, category: str, skip=()):
    """Register every public function of an op module (``__all__``) that
    no decorator registered, but those in ``skip``."""
    for n in getattr(module, "__all__", ()):
        fn = getattr(module, n, None)
        if n in OPS or n in skip or not callable(fn) or isinstance(fn, type):
            continue
        OPS[n] = OpDef(name=n, category=category, lowering=fn,
                       doc=(fn.__doc__ or ""))


def op_names():
    return sorted(OPS)
