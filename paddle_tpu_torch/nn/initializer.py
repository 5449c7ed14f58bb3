"""Weight initializers (counterpart of ``paddle_tpu/nn/initializer.py``).

Each initializer is a function of (shape, dtype) that returns a new
``torch.Tensor`` on the current device, drawn from that device's
Paddle-API generator (``core.generator.default_generator``), so
initialization is reproducible from ``paddle.seed``. Draws are made in
fp32 and cast to ``dtype``. A torch generator never gives a JAX key's
numbers: tests carry weights across (``models/convert.py``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.generator import default_generator
from ..core.place import current_device
from ..core.tensor import Tensor


def _normal(shape, dtype, mean=0.0, std=1.0):
    dev = current_device()
    z = torch.randn(tuple(shape), generator=default_generator(dev),
                    device=dev)
    return (mean + std * z).to(dtype)


def _uniform(shape, dtype, low, high):
    dev = current_device()
    u = torch.rand(tuple(shape), generator=default_generator(dev), device=dev)
    return (low + (high - low) * u).to(dtype)


class Initializer:
    def __call__(self, shape, dtype=dtypes.float32):
        raise NotImplementedError

    def apply(self, tensor: Tensor):
        tensor.set_value(self(tensor.shape, tensor.dtype))
        return tensor


def _fan_in_out(shape):
    shape = list(shape)
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        # Linear weight is (in_features, out_features) in the reference.
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=dtypes.float32):
        return torch.full(tuple(shape), self.value, dtype=dtype,
                          device=current_device())


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=dtypes.float32):
        return _normal(shape, dtype, self.mean, self.std)


class TruncatedNormal(Initializer):
    """Normal truncated to [mean + a*std, mean + b*std] (default 2 std),
    by the inverse CDF of a uniform draw."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype=dtypes.float32):
        cdf = lambda v: 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))
        u = _uniform(shape, torch.float32, 2 * cdf(self.a) - 1,
                     2 * cdf(self.b) - 1)
        r = torch.erfinv(u) * math.sqrt(2.0)
        return (self.mean + self.std * r.clamp(self.a, self.b)).to(dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=dtypes.float32):
        return _uniform(shape, dtype, self.low, self.high)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=dtypes.float32):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        return _normal(shape, dtype,
                       std=self.gain * math.sqrt(2.0 / (fi + fo)))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=dtypes.float32):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, dtype, -limit, limit)


def _kaiming_gain(negative_slope, nonlinearity):
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        return math.sqrt(2.0 / (1 + negative_slope ** 2))
    if nonlinearity in ("tanh",):
        return 5.0 / 3
    return 1.0


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype=dtypes.float32):
        fi, _ = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        std = _kaiming_gain(self.negative_slope, self.nonlinearity) \
            / math.sqrt(fi)
        return _normal(shape, dtype, std=std)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype=dtypes.float32):
        fi, _ = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        limit = (_kaiming_gain(self.negative_slope, self.nonlinearity)
                 * math.sqrt(3.0 / fi))
        return _uniform(shape, dtype, -limit, limit)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype=dtypes.float32):
        v = self.value
        if isinstance(v, Tensor):
            v = v._data
        arr = torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v).to(device=current_device(), dtype=dtype)
        return arr.reshape(tuple(shape))


class Orthogonal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype=dtypes.float32):
        shape = tuple(shape)
        rows = shape[0]
        cols = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        flat = _normal((max(rows, cols), min(rows, cols)), torch.float32)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q[:rows, :cols]).reshape(shape).to(dtype)


class Dirac(Initializer):
    """Identity-preserving conv init (reference nn/initializer/dirac.py)."""

    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype=dtypes.float32):
        shape = tuple(shape)
        arr = np.zeros(shape, dtype=np.float32)
        out_per_group = shape[0] // self.groups
        mid = tuple(s // 2 for s in shape[2:])
        for g in range(self.groups):
            for i in range(min(out_per_group, shape[1])):
                arr[(g * out_per_group + i, i) + mid] = 1.0
        return torch.from_numpy(arr).to(device=current_device(), dtype=dtype)


# functional aliases matching paddle.nn.initializer module surface
constant = Constant
normal = Normal
uniform = Uniform
xavier_normal = XavierNormal
xavier_uniform = XavierUniform
kaiming_normal = KaimingNormal
kaiming_uniform = KaimingUniform

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Orthogonal", "Dirac",
]
