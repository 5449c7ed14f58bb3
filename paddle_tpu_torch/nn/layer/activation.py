"""Activation layers (counterpart of ``paddle_tpu/nn/layer/activation.py``):
those whose functionals the port has; the rest are still to port."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer


class ReLU(Layer):
    def forward(self, x):
        return F.relu(x)


class ReLU6(Layer):
    def forward(self, x):
        return F.relu6(x)


class Swish(Layer):
    def forward(self, x):
        return F.swish(x)


class Hardswish(Layer):
    def forward(self, x):
        return F.hardswish(x)


class Hardsigmoid(Layer):
    def forward(self, x):
        return F.hardsigmoid(x)


class Sigmoid(Layer):
    def forward(self, x):
        return F.sigmoid(x)


class Tanh(Layer):
    def forward(self, x):
        return F.tanh(x)


class Silu(Layer):
    def forward(self, x):
        return F.silu(x)


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return F.gelu(x, approximate=self._approximate)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.softmax(x, self._axis)
