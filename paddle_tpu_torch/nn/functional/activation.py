"""Activations (counterpart of ``paddle_tpu/nn/functional/activation.py``):
plain PyTorch, so that ``to_static``'s tracer records torch's own ops.
``softmax`` is on amp's black list and casts its input for it."""
from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as TF

from ...amp.state import amp_cast
from ...core.dtype import convert_dtype


def gelu(x: torch.Tensor, approximate: bool = False, name=None) -> torch.Tensor:
    """Exact (erf) gelu, or the tanh approximation with ``approximate``."""
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def silu(x: torch.Tensor, name=None) -> torch.Tensor:
    return TF.silu(x)


def relu(x: torch.Tensor, name=None) -> torch.Tensor:
    return TF.relu(x)


def softmax(x: torch.Tensor, axis: int = -1, dtype=None,
            name=None) -> torch.Tensor:
    """softmax over ``axis``; ``dtype`` casts the input first."""
    (x,) = amp_cast("softmax", x)
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    return TF.softmax(x, dim=axis)


def swiglu(x: torch.Tensor, y: Optional[torch.Tensor] = None,
           name=None) -> torch.Tensor:
    """silu(x) * y; with one argument, x is split in half on the last dim.
    One op to the fusion pass, as in the JAX package (no pattern takes it)."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return TF.silu(x) * y


__all__ = ["gelu", "silu", "relu", "softmax", "swiglu"]
