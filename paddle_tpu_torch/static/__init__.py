"""The static-graph surface (counterpart of
``paddle_tpu/static/__init__.py``): ``InputSpec``; ``Program``,
``program_guard``, ``data`` and ``Executor`` (``program.py``);
``static.nn``'s layer helpers and control flow; and the rest of the
reference's names (``tail.py``: gradients, scopes, save/load, the
inference model, the metrics, the places). The JAX package's program
verifier is still to port (ROADMAP).

An ``InputSpec`` declares a program input's shape (-1 or None: any
size), dtype and name; ``jit.to_static(input_spec=...)`` checks the
Tensor arguments against it on every call.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core.dtype import dtype_name



class InputSpec:
    def __init__(self, shape: Sequence[Optional[int]], dtype="float32",
                 name: Optional[str] = None, stop_gradient: bool = True):
        self.shape = tuple(-1 if s is None else int(s) for s in shape)
        self.dtype = _name(dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tensor.shape, dtype_name(tensor.dtype), name)

    @classmethod
    def from_numpy(cls, ndarray, name=None):
        return cls(ndarray.shape, str(ndarray.dtype), name)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype!r}, "
                f"name={self.name!r})")


def _name(dtype) -> str:
    """A dtype's Paddle name: the port's for torch dtypes and "bfloat16"
    (numpy has no bf16), numpy's for the rest."""
    import torch
    if isinstance(dtype, torch.dtype):
        return dtype_name(dtype)
    return "bfloat16" if dtype == "bfloat16" else str(np.dtype(dtype))


from .program import (CompiledProgram, Executor, Program,  # noqa: E402
                      data, default_main_program,
                      default_startup_program, program_guard)
from . import nn  # noqa: E402
from .nn import ExponentialMovingAverage, py_func  # noqa: E402
from .tail import *  # noqa: E402,F401,F403
from . import tail as _tail  # noqa: E402

__all__ = ["InputSpec", "Program", "program_guard", "data", "Executor",
           "CompiledProgram", "default_main_program",
           "default_startup_program", "nn", "ExponentialMovingAverage",
           "py_func"] + _tail.__all__
