"""The port's ``torch.nn`` modules: ``TorchLinear``, ``TorchLayerNorm`` and
``TorchRMSNorm``, the layers the torch-level GPT-2 and LLaMA are built
from (their forward is the port's functionals on ``torch.Tensor``s, so
amp casts their inputs and ``to_static`` records one op each).

They keep torch's layouts and init (``TorchLinear``'s weight is (out,
in)). The Paddle-API ``nn.Linear``, ``nn.LayerNorm`` and ``nn.RMSNorm``
are the ``Layer``s of ``common.py`` and ``norm.py``, as in the JAX
package.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F


class TorchLinear(nn.Linear):
    """``torch.nn.Linear`` (its parameters, layout and init) whose forward
    is the port's ``F.linear``, so that amp casts its inputs and
    ``to_static`` records it as one ``linear`` op."""

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class TorchLayerNorm(nn.LayerNorm):
    """``torch.nn.LayerNorm`` (its parameters and init) whose forward is
    the port's ``F.layer_norm``, so that amp casts its inputs. A
    ``torch.nn.LayerNorm``, so O2 ``decorate`` keeps it fp32."""

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            epsilon=self.eps)


class TorchRMSNorm(nn.Module):
    """x / rms(x) * weight over the last dim, statistics in fp32; the
    parameter ``weight`` starts at 1. Not a LayerNorm: O2 ``decorate``
    casts its weight, as the JAX package's."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6, device=None,
                 dtype=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self._epsilon)
