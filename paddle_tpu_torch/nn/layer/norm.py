"""LayerNorm and RMSNorm (counterparts of ``LayerNorm`` and ``RMSNorm`` in
``paddle_tpu/nn/layer/norm.py``)."""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F


class LayerNorm(nn.LayerNorm):
    """``torch.nn.LayerNorm`` (its parameters and init) whose forward is
    the port's ``F.layer_norm``, so that amp casts its inputs. A
    ``torch.nn.LayerNorm``, so O2 ``decorate`` keeps it fp32."""

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            epsilon=self.eps)


class RMSNorm(nn.Module):
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
