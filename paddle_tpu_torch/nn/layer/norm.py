"""RMSNorm (counterpart of ``RMSNorm`` in ``paddle_tpu/nn/layer/norm.py``)."""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F


class RMSNorm(nn.Module):
    """x / rms(x) * weight over the last dim, statistics in fp32; the
    parameter ``weight`` starts at 1."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6, device=None,
                 dtype=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self._epsilon)
