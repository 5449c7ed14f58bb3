"""Normalization functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``): layer, RMS, batch, group and
instance norms with statistics in fp32 and the output in the input's
dtype, as the JAX lowerings compute them, and ``normalize`` and
``local_response_norm`` in the input's dtype. The layer and RMS norms
are on amp's black list: under O1/O2 their inputs go to fp32 first, so
they return fp32.

On Paddle ``Tensor``s each is one op through ``core.dispatch.call``
with the same math; on ``torch.Tensor``s, the torch-level function.
``batch_norm`` (the Paddle API's only) keeps its running statistics in
the Paddle Tensors it is handed, as the JAX package's does: they are
inputs of its op, updated in place, so a program ``to_static`` replays
reads and updates the buffers' payloads of the call, not the ones it
recorded. The norms' attrs (``epsilon``, ``norm_ndim``, ``has_w``,
``has_b``) are the JAX package's, which the fusion pass matches on."""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch.nn import functional as TF

from ...amp.state import amp_cast
from ...core import dispatch
from ...core.tensor import Tensor
from ._op import call


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.float()


def _affine(y: torch.Tensor, weight: Optional[torch.Tensor],
            bias: Optional[torch.Tensor]) -> torch.Tensor:
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y


def _affine_inputs(name, body, x, weight, bias, attrs=None, extra=(),
                   export_attrs=None):
    """One Paddle-API norm op over x, whichever of weight/bias exist and
    the tensors ``extra`` (no gradient); ``body(a, w, b, *extra)``.
    ``attrs`` ride the record (the lowering ignores them);
    ``export_attrs()`` goes to the export hooks."""
    ins = [x] + [t for t in (weight, bias) if t is not None] + list(extra)
    has_w, has_b = weight is not None, bias is not None
    n = 1 + has_w + has_b

    def f(a, *rest, **_attrs):
        w = rest[0] if has_w else None
        b = rest[has_w] if has_b else None
        return body(a, w, b, *rest[n - 1:])
    mask = [True] * n + [False] * len(extra) if extra else None
    return dispatch.call(name, f, ins, attrs=attrs, differentiable_mask=mask,
                         export_attrs=export_attrs)


def layer_norm(x, normalized_shape: Union[int, Sequence[int]],
               weight=None, bias=None, epsilon: float = 1e-5, name=None):
    """(x - mean) / sqrt(var + epsilon) * weight + bias over the trailing
    ``normalized_shape`` dims. Where the weight and bias share x's dtype,
    torch's own layer norm computes it (fp32 statistics and affine, one
    rounding); otherwise x and the parameters go to fp32 and the result
    back to x's dtype."""
    if isinstance(x, Tensor):
        ndim = 1 if isinstance(normalized_shape, int) \
            else len(normalized_shape)
        return _affine_inputs("layer_norm", lambda a, w, b: layer_norm(
            a, normalized_shape, w, b, epsilon), x, weight, bias,
            {"epsilon": epsilon, "norm_ndim": ndim,
             "has_w": weight is not None, "has_b": bias is not None})
    x, weight, bias = amp_cast("layer_norm", x, weight, bias)
    shape = ((normalized_shape,) if isinstance(normalized_shape, int)
             else tuple(normalized_shape))
    if all(t is None or t.dtype == x.dtype for t in (weight, bias)):
        return TF.layer_norm(x, shape, weight, bias, epsilon)
    return TF.layer_norm(x.float(), shape, _f32(weight), _f32(bias),
                         epsilon).to(x.dtype)


def rms_norm(x, weight=None, bias=None, epsilon: float = 1e-6,
             begin_norm_axis: int = -1, name=None):
    """x / sqrt(mean(x^2) + epsilon) * weight + bias over the dims from
    ``begin_norm_axis`` on."""
    if isinstance(x, Tensor):
        return _affine_inputs("rms_norm", lambda a, w, b: rms_norm(
            a, w, b, epsilon, begin_norm_axis), x, weight, bias,
            {"epsilon": epsilon, "norm_ndim": x.ndim - begin_norm_axis
             % max(x.ndim, 1), "has_w": weight is not None,
             "has_b": bias is not None})
    x, weight, bias = amp_cast("rms_norm", x, weight, bias)
    axis = begin_norm_axis % x.dim()
    dims = tuple(range(axis, x.dim()))
    a32 = x.float()
    ms = (a32 * a32).mean(dim=dims, keepdim=True)
    y = a32 * (1.0 / torch.sqrt(ms + epsilon))
    return _affine(y, weight, bias).to(x.dtype)


def batch_norm(x: Tensor, running_mean: Tensor, running_var: Tensor,
               weight=None, bias=None, training: bool = False,
               momentum: float = 0.9, epsilon: float = 1e-5,
               data_format: str = "NCHW", use_global_stats=None, name=None):
    """Batch norm over the channel axis in fp32 (the output in x's dtype).
    Training (unless ``use_global_stats``) normalizes by the batch's
    statistics and updates the running ones in place:
    running = momentum * running + (1 - momentum) * batch, the variance
    unbiased."""
    channel_last = data_format in ("NHWC", "NLC", "NDHWC")
    use_batch = training and not use_global_stats

    def body(a, w, b, rm, rv):
        a32 = a.float()
        if channel_last:
            a32 = a32.movedim(-1, 1)
        y = TF.batch_norm(a32, rm, rv, _f32(w), _f32(b), use_batch,
                          1.0 - momentum, epsilon)
        return (y.movedim(1, -1) if channel_last else y).to(a.dtype)
    def export():                   # host copies, for an ONNX export only
        return {"epsilon": epsilon, "ch_axis": -1 if channel_last else 1,
                "has_w": weight is not None, "has_b": bias is not None,
                "mean": running_mean.numpy().astype(np.float32),
                "var": running_var.numpy().astype(np.float32)}
    return _affine_inputs("batch_norm", body, x, weight, bias,
                          extra=(running_mean, running_var),
                          export_attrs=export)


def _channel_affine(y, wb, has_w, has_b):
    """y * weight + bias over the channel axis 1, in fp32."""
    shape = [1, y.shape[1]] + [1] * (y.dim() - 2)
    if has_w:
        y = y * wb[0].float().reshape(shape)
    if has_b:
        y = y + wb[has_w].float().reshape(shape)
    return y


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Normalize the channels in ``num_groups`` groups (fp32 statistics
    over each group's channels and the spatial dims)."""
    channel_last = data_format in ("NHWC", "NLC", "NDHWC")
    has_w, has_b = weight is not None, bias is not None

    def body(a, *wb):
        a32 = a.float()
        if channel_last:
            a32 = a32.movedim(-1, 1)
        n, c = a32.shape[:2]
        spatial = tuple(a32.shape[2:])
        g = a32.reshape((n, num_groups, c // num_groups) + spatial)
        dims = tuple(range(2, g.dim()))
        mean = g.mean(dim=dims, keepdim=True)
        var = g.var(dim=dims, keepdim=True, unbiased=False)
        y = ((g - mean) / torch.sqrt(var + epsilon)).reshape(
            (n, c) + spatial)
        y = _channel_affine(y, wb, has_w, has_b)
        return (y.movedim(1, -1) if channel_last else y).to(a.dtype)
    return call("group_norm", body, [t for t in (x, weight, bias)
                                     if t is not None])


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Normalize each sample's channels over their spatial dims (fp32
    statistics). The running statistics are accepted and, as in the JAX
    package, neither read nor updated."""
    has_w, has_b = weight is not None, bias is not None

    def body(a, *wb):
        a32 = a.float()
        dims = tuple(range(2, a.dim()))
        mean = a32.mean(dim=dims, keepdim=True)
        var = a32.var(dim=dims, keepdim=True, unbiased=False)
        y = _channel_affine((a32 - mean) / torch.sqrt(var + eps), wb, has_w,
                            has_b)
        return y.to(a.dtype)
    return call("instance_norm", body, [t for t in (x, weight, bias)
                                        if t is not None])


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """x / max(||x||_p, epsilon) along ``axis``."""
    def body(a):
        if p == np.inf:
            n = a.abs().amax(dim=axis, keepdim=True)
        else:
            n = (a.abs() ** p).sum(dim=axis, keepdim=True) ** (1.0 / p)
        return a / n.clamp_min(epsilon)
    return call("normalize", body, [x])


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """x / (k + alpha * sum of x^2 over ``size`` neighbouring
    channels)^beta, the window zero-padded at the ends."""
    def body(a):
        ch = 1 if data_format.startswith("NC") else a.dim() - 1
        c = a.shape[ch]
        half = size // 2
        sq = (a * a).movedim(ch, -1)
        padded = TF.pad(sq, (half, size - half - 1)).movedim(-1, ch)
        acc = torch.zeros_like(a)
        for i in range(size):
            acc = acc + padded.narrow(ch, i, c)
        return a / (k + alpha * acc) ** beta
    return call("local_response_norm", body, [x])


__all__ = ["layer_norm", "rms_norm", "batch_norm", "group_norm",
           "instance_norm", "normalize", "local_response_norm"]
