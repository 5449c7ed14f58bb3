"""The rest of the layers (counterpart of ``paddle_tpu/nn/layer/tail.py``):
losses, unpools, fractional and LP pools, ``Softmax2D``, ``Unflatten``
and the 1-D/3-D zero pads, each over its Paddle-API functional."""
from __future__ import annotations

from ... import ops
from .. import functional as F
from .layers import Layer

__all__ = [
    "PoissonNLLLoss", "MultiLabelSoftMarginLoss", "MultiMarginLoss",
    "SoftMarginLoss", "GaussianNLLLoss", "TripletMarginWithDistanceLoss",
    "AdaptiveLogSoftmaxWithLoss", "RNNTLoss", "HSigmoidLoss",
    "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D", "FractionalMaxPool2D",
    "FractionalMaxPool3D", "LPPool1D", "LPPool2D", "Softmax2D",
    "Unflatten", "ZeroPad1D", "ZeroPad3D",
]


class PoissonNLLLoss(Layer):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__()
        self._args = (log_input, full, epsilon, reduction)

    def forward(self, input, label):
        return F.poisson_nll_loss(input, label, *self._args)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.multi_label_soft_margin_loss(
            input, label, self.weight, self.reduction)


class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__()
        self._args = (p, margin, weight, reduction)

    def forward(self, input, label):
        return F.multi_margin_loss(input, label, *self._args)


class SoftMarginLoss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.soft_margin_loss(input, label, self.reduction)


class GaussianNLLLoss(Layer):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean",
                 name=None):
        super().__init__()
        self._args = (full, epsilon, reduction)

    def forward(self, input, label, variance):
        return F.gaussian_nll_loss(input, label, variance, *self._args)


class TripletMarginWithDistanceLoss(Layer):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self._args = (distance_function, margin, swap, reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_with_distance_loss(
            input, positive, negative, *self._args)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """reference loss.py AdaptiveLogSoftmaxWithLoss: owns the head and
    per-cluster tail projections; ``cutoffs`` EXCLUDES n_classes (the
    reference constructor contract)."""

    def __init__(self, in_features, n_classes, cutoffs,
                 div_value=4.0, head_bias=False, name=None):
        super().__init__()
        cutoffs = list(cutoffs)
        if not cutoffs or cutoffs != sorted(cutoffs) \
                or cutoffs[-1] > n_classes - 1:
            raise ValueError("cutoffs must be sorted and < n_classes")
        self.cutoffs = cutoffs + [n_classes]
        self.shortlist = cutoffs[0]
        n_clusters = len(self.cutoffs) - 1
        head_size = self.shortlist + n_clusters
        self.head_weight = self.create_parameter(
            [in_features, head_size])
        self.head_bias = (self.create_parameter([head_size], is_bias=True)
                          if head_bias else None)
        self.tail_weights = []
        for i in range(n_clusters):
            proj = max(1, int(in_features / (div_value ** (i + 1))))
            size = self.cutoffs[i + 1] - self.cutoffs[i]
            w1 = self.create_parameter([in_features, proj])
            w2 = self.create_parameter([proj, size])
            self.add_parameter(f"tail_{i}_proj", w1)
            self.add_parameter(f"tail_{i}_out", w2)
            self.tail_weights.append((w1, w2))

    def forward(self, input, label):
        return F.adaptive_log_softmax_with_loss(
            input, label, self.head_weight, self.tail_weights,
            self.cutoffs, head_bias=self.head_bias)


class RNNTLoss(Layer):
    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean",
                 name=None):
        super().__init__()
        self._args = (blank, fastemit_lambda, reduction)

    def forward(self, logits, labels, logit_lengths, label_lengths):
        blank, fastemit, reduction = self._args
        return F.rnnt_loss(logits, labels, logit_lengths, label_lengths,
                           blank=blank, fastemit_lambda=fastemit,
                           reduction=reduction)


class HSigmoidLoss(Layer):
    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        self.num_classes = num_classes
        self.weight = self.create_parameter(
            [num_classes - 1, feature_size], attr=weight_attr)
        self.bias = (None if bias_attr is False else
                     self.create_parameter([num_classes - 1],
                                           attr=bias_attr, is_bias=True))

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self.num_classes,
                               self.weight, bias=self.bias,
                               path_table=path_table,
                               path_code=path_code)


def _unpool(fname):
    class _UnPool(Layer):
        def __init__(self, kernel_size, stride=None, padding=0,
                     data_format=None, output_size=None, name=None):
            super().__init__()
            self._args = (kernel_size, stride, padding, output_size)

        def forward(self, x, indices):
            kernel_size, stride, padding, output_size = self._args
            return getattr(F, fname)(
                x, indices, kernel_size, stride=stride, padding=padding,
                output_size=output_size)
    _UnPool.__name__ = fname.title().replace("_", "").replace(
        "Maxunpool", "MaxUnPool")
    return _UnPool


MaxUnPool1D = _unpool("max_unpool1d")
MaxUnPool2D = _unpool("max_unpool2d")
MaxUnPool3D = _unpool("max_unpool3d")


class FractionalMaxPool2D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self._args = (output_size, kernel_size, random_u, return_mask)

    def forward(self, x):
        output_size, kernel_size, random_u, return_mask = self._args
        return F.fractional_max_pool2d(
            x, output_size, kernel_size=kernel_size, random_u=random_u,
            return_mask=return_mask)


class FractionalMaxPool3D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self._args = (output_size, kernel_size, random_u, return_mask)

    def forward(self, x):
        output_size, kernel_size, random_u, return_mask = self._args
        return F.fractional_max_pool3d(
            x, output_size, kernel_size=kernel_size, random_u=random_u,
            return_mask=return_mask)


class LPPool1D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCL", name=None):
        super().__init__()
        self._args = (norm_type, kernel_size, stride, padding, ceil_mode)

    def forward(self, x):
        norm_type, kernel_size, stride, padding, ceil_mode = self._args
        return F.lp_pool1d(x, norm_type, kernel_size, stride=stride,
                           padding=padding, ceil_mode=ceil_mode)


class LPPool2D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self._args = (norm_type, kernel_size, stride, padding, ceil_mode)

    def forward(self, x):
        norm_type, kernel_size, stride, padding, ceil_mode = self._args
        return F.lp_pool2d(x, norm_type, kernel_size, stride=stride,
                           padding=padding, ceil_mode=ceil_mode)


class Softmax2D(Layer):
    """softmax over the channel axis of NCHW input (reference
    Softmax2D)."""

    def forward(self, x):
        if x.ndim not in (3, 4):
            raise ValueError(
                f"Softmax2D expects 3D/4D input, got {x.ndim}D")
        return F.softmax(x, axis=-3)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis = axis
        self.shape = shape

    def forward(self, x):
        axis = self.axis % x.ndim
        shape = list(x.shape)
        return ops.reshape(x, shape[:axis] + list(self.shape)
                           + shape[axis + 1:])


class _ZeroPadNd(Layer):
    def __init__(self, padding, data_format, name=None):
        super().__init__()
        self.padding = padding
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, mode="constant", value=0.0,
                     data_format=self.data_format)


class ZeroPad1D(_ZeroPadNd):
    def __init__(self, padding, data_format="NCL", name=None):
        super().__init__(padding, data_format)


class ZeroPad3D(_ZeroPadNd):
    def __init__(self, padding, data_format="NCDHW", name=None):
        super().__init__(padding, data_format)
