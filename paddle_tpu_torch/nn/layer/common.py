"""``Linear`` (counterpart of ``Linear`` in ``paddle_tpu/nn/layer/common.py``)."""
from __future__ import annotations

from torch import nn

from .. import functional as F


class Linear(nn.Linear):
    """``torch.nn.Linear`` (its parameters, layout and init) whose forward
    is the port's ``F.linear``, so that amp casts its inputs and
    ``to_static`` records it as one ``linear`` op."""

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)
