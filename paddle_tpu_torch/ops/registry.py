"""Declarative op registry (counterpart of ``paddle_tpu/ops/registry.py``).

An ``OpDef`` records a Paddle-API op's name, category and function. The
JAX package's ``cost_fn`` and ``spmd_rule`` fields wait for the port of
``observability/perf`` and ``distributed/spmd``.
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


OPS: Dict[str, OpDef] = {}


def register(name: str, category: str = "misc", differentiable: bool = True):
    """Decorator registering a user-facing op function."""

    def deco(fn):
        OPS[name] = OpDef(name=name, category=category, lowering=fn,
                          differentiable=differentiable,
                          doc=(fn.__doc__ or ""))
        return fn

    return deco


def register_module(module, category: str):
    """Register every public function of an op module (``__all__``) that
    no decorator registered."""
    for n in getattr(module, "__all__", ()):
        fn = getattr(module, n, None)
        if n in OPS or not callable(fn) or isinstance(fn, type):
            continue
        OPS[n] = OpDef(name=n, category=category, lowering=fn,
                       doc=(fn.__doc__ or ""))


def op_names():
    return sorted(OPS)
