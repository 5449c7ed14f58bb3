"""The entry of the functionals whose one body serves both kinds of
input: ``call`` runs ``body`` directly over ``torch.Tensor``s (the
torch-level function) and as one dispatched op over Paddle ``Tensor``s
(other data becomes a Tensor on the current device)."""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ...core import dispatch
from ...core.tensor import Tensor, as_tensor


def call(name: str, body: Callable, inputs: Sequence,
         mask: Optional[Sequence[bool]] = None):
    """``body(*inputs)``; through ``dispatch.call`` under the JAX
    package's op ``name`` unless every input is a ``torch.Tensor``.
    ``mask`` marks the inputs that take a gradient."""
    if all(isinstance(x, torch.Tensor) for x in inputs):
        return body(*inputs)
    return dispatch.call(name, body, [x if isinstance(x, Tensor)
                                      else as_tensor(x) for x in inputs],
                         differentiable_mask=mask)

