"""Norm layers (counterpart of ``paddle_tpu/nn/layer/norm.py``):
``LayerNorm``, ``RMSNorm`` and the batch norms, Paddle-API ``Layer``s
over the Paddle-API functionals. The batch norms keep their running
statistics in the buffers ``_mean`` and ``_variance``; ``SyncBatchNorm``
all-reduces its batch statistics over the ``distributed`` group. The
group, instance, local-response and spectral norms follow."""
from __future__ import annotations

import numpy as np
import torch

from ...core.generator import default_generator
from ...core.place import current_device
from ...core.tensor import Tensor
from .. import functional as F
from ..functional._op import call
from ..initializer import Constant
from .layers import Layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        if weight_attr is not False:
            self.weight = self.create_parameter(
                self._normalized_shape, attr=weight_attr,
                default_initializer=Constant(1.0))
        else:
            self.weight = None
        if bias_attr is not False:
            self.bias = self.create_parameter(
                self._normalized_shape, attr=bias_attr, is_bias=True)
        else:
            self.bias = None

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}, epsilon={self._epsilon}"


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None, name=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr, default_initializer=Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self._epsilon)


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        if weight_attr is not False:
            self.weight = self.create_parameter(
                [num_features], attr=weight_attr,
                default_initializer=Constant(1.0))
        else:
            self.weight = None
        if bias_attr is not False:
            self.bias = self.create_parameter(
                [num_features], attr=bias_attr, is_bias=True)
        else:
            self.bias = None
        dev = current_device()
        self.register_buffer("_mean", Tensor(torch.zeros(num_features,
                                                         device=dev)))
        self.register_buffer("_variance", Tensor(torch.ones(num_features,
                                                            device=dev)))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the default group's processes; its gradient is the
    sum of the processes' gradients."""

    @staticmethod
    def forward(ctx, x):
        import torch.distributed as dist
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


class SyncBatchNorm(_BatchNormBase):
    """Batch norm whose training statistics span every process of the
    default ``distributed`` group: the per-channel sums, sums of squares
    and counts are all-reduced (differentiably), then the batch is
    normalized and the running statistics move as ``BatchNorm``'s do.
    On one process, or out of training, it is ``BatchNorm``."""

    def forward(self, x):
        import torch.distributed as dist
        if not (self.training and not self._use_global_stats
                and dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1):
            return super().forward(x)
        channel_last = self._data_format in ("NHWC", "NLC", "NDHWC")
        mom, eps = self._momentum, self._epsilon
        has_w, has_b = self.weight is not None, self.bias is not None

        def body(a, rm, rv, *wb):
            a32 = (a.movedim(-1, 1) if channel_last else a).float()
            dims = [0] + list(range(2, a32.dim()))
            count = torch.tensor([a32.numel() / a32.shape[1]],
                                 device=a.device)
            stats = _AllReduceSum.apply(torch.cat([a32.sum(dims),
                                                   (a32 * a32).sum(dims),
                                                   count]))
            c = a32.shape[1]
            n = stats[-1]
            mean = stats[:c] / n
            var = stats[c:2 * c] / n - mean * mean
            with torch.no_grad():
                rm.mul_(mom).add_((1 - mom) * mean)
                rv.mul_(mom).add_((1 - mom) * var * n / (n - 1).clamp_min(1))
            shape = [1, c] + [1] * (a32.dim() - 2)
            y = (a32 - mean.reshape(shape)) / torch.sqrt(
                var.reshape(shape) + eps)
            if has_w:
                y = y * wb[0].float().reshape(shape)
            if has_b:
                y = y + wb[has_w].float().reshape(shape)
            return (y.movedim(1, -1) if channel_last else y).to(a.dtype)
        ins = [x, self._mean, self._variance] + [
            t for t in (self.weight, self.bias) if t is not None]
        return call("sync_batch_norm", body, ins,
                    mask=[True, False, False] + [True] * (has_w + has_b))

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm under it made a SyncBatchNorm
        holding the same parameters and statistics."""
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            out = cls(layer._num_features, layer._momentum, layer._epsilon,
                      data_format=layer._data_format)
            if layer.weight is not None:
                out.weight.set_value(layer.weight)
            if layer.bias is not None:
                out.bias.set_value(layer.bias)
            out._mean.set_value(layer._mean)
            out._variance.set_value(layer._variance)
        for name, sub in list(layer._sub_layers.items()):
            if sub is not None:
                out._sub_layers[name] = cls.convert_sync_batchnorm(sub)
        return out


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self._data_format = data_format
        if weight_attr is not False:
            self.weight = self.create_parameter(
                [num_channels], attr=weight_attr,
                default_initializer=Constant(1.0))
        else:
            self.weight = None
        if bias_attr is not False:
            self.bias = self.create_parameter(
                [num_channels], attr=bias_attr, is_bias=True)
        else:
            self.bias = None

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        if weight_attr is not False:
            self.scale = self.create_parameter(
                [num_features], attr=weight_attr,
                default_initializer=Constant(1.0))
        else:
            self.scale = None
        if bias_attr is not False:
            self.bias = self.create_parameter(
                [num_features], attr=bias_attr, is_bias=True)
        else:
            self.bias = None

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(Layer):
    """A weight divided by its largest singular value, from
    ``power_iters`` power iterations that start at the parameters
    ``weight_u``/``weight_v`` (drawn once, from the device's Paddle-API
    generator, and never updated, as in the JAX package)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 dtype="float32"):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._epsilon = epsilon
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        g = default_generator(current_device())
        for name, n in (("weight_u", h), ("weight_v", w)):
            p = self.create_parameter([n], attr=None)
            p.set_value(torch.randn(n, generator=g, device=g.device))
            p.stop_gradient = True
            setattr(self, name, p)

    def forward(self, weight):
        dim, eps, iters = self._dim, self._epsilon, self._power_iters

        def body(wa, u, v):
            m = wa.movedim(dim, 0).reshape(wa.shape[dim], -1)
            for _ in range(iters):
                v = m.t() @ u
                v = v / (torch.linalg.vector_norm(v) + eps)
                u = m @ v
                u = u / (torch.linalg.vector_norm(u) + eps)
            return wa / (u @ m @ v)
        return call("spectral_norm", body, [weight, self.weight_u,
                                            self.weight_v],
                    mask=[True, False, False])
