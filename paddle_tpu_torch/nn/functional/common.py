"""The common functionals (counterpart of
``paddle_tpu/nn/functional/common.py``, and of ``matmul`` in
``paddle_tpu/ops/linalg.py``): linear, matmul, the dropouts, the
embeddings, one_hot, pad, interpolate, unfold/fold, the pixel and
channel shuffles, the similarities, label smoothing and sequence_mask.

``interpolate`` follows the JAX package's rules, not torch's defaults:
"nearest" takes floor((i + 0.5) * in / out); with ``align_corners``
every other mode is linear between aligned corners; otherwise the
weights are ``jax.image.resize``'s (half-pixel centres; triangle or
Keys-cubic a = -0.5 kernels widened by the scale when shrinking, each
column normalized). ``pad``'s reflect, replicate and circular modes
gather numpy's "reflect", "edge" and "wrap" indices.

Each entry takes two kinds of input. Called on Paddle ``Tensor``s (the
Paddle API, ``import paddle_tpu_torch as paddle``) it is one op through
``core.dispatch.call`` with the JAX package's semantics. Called on
``torch.Tensor``s (the port's torch-level models and the fusion pass's
traced calls) it runs as the torch-level function it always was. The
one difference of layout: ``linear`` on Paddle Tensors takes Paddle's
(in, out) weight, and on torch.Tensors torch's ``nn.Linear`` (out, in)
weight; the Paddle entry hands the torch body ``weight.t()``, a view.
Both products cast their inputs for amp (``amp_cast``, white list).

The JAX package draws its dropout mask from a global key. The
torch-level dropout draws it from the ``torch.Generator`` the caller
hands in and raises without one; the Paddle entry draws from the
device's Paddle-API generator (``core.generator.default_generator``),
as ``alpha_dropout`` does on either kind of input. None draws from
torch's global RNG. The functionals this slice added run one body over
either kind of input (``_op.call``).
"""
from __future__ import annotations

import sys
from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch.nn import functional as TF

from ...amp.state import amp_cast
from ...core import dispatch
from ...core.generator import default_generator
from ...core.dtype import convert_dtype
from ...core.tensor import Tensor, _payload, as_tensor
from ...ops.linalg import matmul as _paddle_matmul, matmul_body
from ...ops.registry import register_module
from ._op import call


def _tensors(*xs):
    """The Paddle Tensors of ``xs`` (non-Tensor data made Tensors), Nones
    dropped."""
    return [x if isinstance(x, Tensor) else as_tensor(x)
            for x in xs if x is not None]


def linear(x, weight, bias=None, name=None):
    """x W + b. On Paddle Tensors W is (in, out), as in the JAX package;
    on torch.Tensors W is (out, in) (x W^T + b), as in ``torch.nn.Linear``.
    The weight and bias are cast to x's dtype, as the JAX package casts
    them."""
    if isinstance(x, Tensor):
        return dispatch.call(
            "linear", lambda a, w, *b: linear(a, w.t(), *b),
            _tensors(x, weight, bias))
    x, weight, bias = amp_cast("linear", x, weight, bias)
    return TF.linear(x, weight.to(x.dtype),
                     None if bias is None else bias.to(x.dtype))


def matmul(x, y, transpose_x: bool = False, transpose_y: bool = False,
           name=None):
    """Batched product with broadcasting (``ops.linalg.matmul_body``);
    ``transpose_x``/``transpose_y`` swap the last two dims of an operand
    of two dims or more. Mixed dtypes promote, as ``jnp.matmul`` promotes
    them. The same layout on Paddle Tensors and torch.Tensors."""
    if isinstance(x, Tensor) or isinstance(y, Tensor):
        return _paddle_matmul(x, y, transpose_x, transpose_y)
    x, y = amp_cast("matmul", x, y)
    return matmul_body(x, y, transpose_x, transpose_y)


def dropout(x, p: float = 0.5,
            axis: Optional[Union[int, Sequence[int]]] = None,
            training: bool = True, mode: str = "upscale_in_train",
            name=None, generator: Optional[torch.Generator] = None):
    """Zero elements with probability ``p`` while training, rescaling the
    survivors by 1/(1-p) (``mode="upscale_in_train"``) or scaling by
    (1-p) at inference (``"downscale_in_infer"``). ``axis`` shares one
    draw along the other dims. The mask comes from ``generator`` (on x's
    device); on a Paddle Tensor with no generator, from the device's
    Paddle-API generator."""
    if isinstance(x, Tensor):
        if not training or p == 0:
            if mode == "downscale_in_infer" and not training:
                return dispatch.call("dropout_scale", lambda a: a * (1 - p),
                                     [x])
            return x
        g = generator or default_generator(x._data.device)
        return dispatch.call("dropout", lambda a: dropout(
            a, p, axis, training, mode, generator=g), [x])
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout: unknown mode {mode!r}")
    if not training or p == 0:
        if mode == "downscale_in_infer" and not training:
            return x * (1 - p)
        return x
    if p == 1:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout: pass a torch.Generator; the port never "
                         "draws from torch's global RNG")
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        axes = [a % x.dim() for a in axes]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = torch.rand(shape, generator=generator, device=x.device) < 1 - p
    y = torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))
    if mode == "upscale_in_train":
        y = y / (1 - p)
    return y


def embedding(x, weight, padding_idx: Optional[int] = None, sparse=False,
              name=None):
    """Rows of ``weight`` (V, H) at the integer ids ``x``; rows of
    ``padding_idx`` give zeros (and no gradient). The ids take no
    gradient."""
    if isinstance(x, Tensor):
        return dispatch.call("embedding", lambda ids, w: embedding(
            ids, w, padding_idx), _tensors(x, weight),
            differentiable_mask=[False, True])
    out = TF.embedding(x.long(), weight)
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx)[..., None], 0.0)
    return out


def channel_shuffle(x, groups: int, data_format: str = "NCHW", name=None):
    """Interleave ``groups`` channel groups, as ShuffleNet does: (N, g,
    C/g, H, W) -> (N, C/g, g, H, W)."""
    if isinstance(x, Tensor):
        return dispatch.call("channel_shuffle", lambda a: channel_shuffle(
            a, groups, data_format), [x])
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    n, c, h, w = x.shape
    y = x.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(
        n, c, h, w)
    if data_format == "NHWC":
        y = y.permute(0, 2, 3, 1)
    return y


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Dropout of whole (N, C) feature maps of a 4-D input."""
    ax = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=ax, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    """Dropout of whole (N, C) feature volumes of a 5-D input."""
    ax = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=ax, training=training)


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


def alpha_dropout(x, p=0.5, training=True, name=None,
                  generator: Optional[torch.Generator] = None):
    """SELU-preserving dropout: a dropped unit takes the negative
    saturation value, then an affine map keeps mean and variance. The
    mask comes from ``generator``, else the device's Paddle-API one."""
    if not training or p == 0:
        return x
    g = generator or default_generator(_payload(x).device)
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    coef_a = ((1 - p) * (1 + p * alpha_p ** 2)) ** -0.5
    coef_b = -coef_a * p * alpha_p

    def body(a):
        keep = torch.rand(a.shape, generator=g, device=a.device) < 1 - p
        return coef_a * torch.where(keep, a, torch.full_like(a, alpha_p)) \
            + coef_b
    return call("alpha_dropout", body, [x])


def embedding_bag(x, weight, mode="sum", padding_idx=None, name=None):
    """Rows of ``weight`` (V, H) at the ids (..., L), summed (or averaged,
    ``mode="mean"``, over the ids that are not ``padding_idx``) over L."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: mode must be sum|mean, "
                         f"got {mode!r}")

    def body(ids, table):
        ids = ids.long()
        rows = table[ids]
        if padding_idx is not None:
            keep = (ids != padding_idx)[..., None]
            rows = torch.where(keep, rows, torch.zeros((), dtype=rows.dtype,
                                                       device=rows.device))
            denom = keep.sum(dim=-2).to(rows.dtype).clamp_min(1.0)
        else:
            denom = float(ids.shape[-1])
        pooled = rows.sum(dim=-2)
        return pooled / denom if mode == "mean" else pooled
    return call("embedding_bag", body, [x, weight], mask=[False, True])


def one_hot(x, num_classes, name=None):
    """fp32 one-hot rows of the integer ids, on the ids' device."""
    return call("one_hot", lambda a: TF.one_hot(
        a.long(), num_classes).to(torch.float32), [x], mask=[False])


def _reflect_index(n: int, lo: int, hi: int, mode: str, device):
    """The source index of each padded position along one dim (numpy's
    "edge", "reflect" and "wrap")."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return i % n
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = i.abs() % period
    return torch.where(i >= n, period - i, i)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Pad with ``mode`` constant (``value``), reflect, replicate or
    circular. ``pad`` gives (before, after) for every dim in order, or,
    with half as many pairs as spatial dims, for the spatial dims last
    dim first (Paddle's layout), as the JAX package reads it."""
    if isinstance(pad, Tensor):
        pad = [int(v) for v in pad.numpy().tolist()]
    pad = [int(v) for v in pad]
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise ValueError(f"pad: unknown mode {mode!r}")

    def body(a):
        nd = a.dim()
        if len(pad) == 2 * nd:
            cfg = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
        else:
            nspatial = len(pad) // 2
            cfg = [(0, 0)] * nd
            channel_last = data_format.endswith("C") and data_format != "NC"
            start = 1 if channel_last else 2
            for i in range(nspatial):
                cfg[start + (nspatial - 1 - i)] = (pad[2 * i], pad[2 * i + 1])
        if mode == "constant":
            flat = [v for lo_hi in reversed(cfg) for v in lo_hi]
            return TF.pad(a, flat, value=value)
        for dim, (lo, hi) in enumerate(cfg):
            if lo or hi:
                a = a.index_select(dim, _reflect_index(
                    a.shape[dim], lo, hi, mode, a.device))
        return a
    return call("pad", body, [x])


def zeropad2d(x, padding, data_format="NCHW", name=None):
    """Zero padding of the two spatial dims: [left, right, top, bottom]."""
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


def _triangle(t):
    return (1 - t.abs()).clamp_min(0)


def _keys_cubic(t):
    out = ((1.5 * t - 2.5) * t) * t + 1.0
    out = torch.where(t >= 1.0, ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0, out)
    return torch.where(t >= 2.0, torch.zeros_like(t), out)


def _resize_weights(n_in: int, n_out: int, kernel, device) -> torch.Tensor:
    """(n_in, n_out) fp32 weights of a resize along one dim: half-pixel
    centres, the kernel widened by the scale when shrinking (antialias),
    columns normalized, samples outside the input zeroed (the weights of
    ``jax.image.resize``)."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * inv_scale - 0.5
    t = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                        device=device)[:, None]).abs() \
        / kernel_scale
    w = kernel(t)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize_nearest(a, axes, out_size):
    for ax, n in zip(axes, out_size):
        m = a.shape[ax]
        if m == n:
            continue
        pos = (torch.arange(n, dtype=torch.float32, device=a.device) + 0.5) \
            * m / n
        a = a.index_select(ax, torch.floor(pos).long())
    return a


def _resize_align_corners(a, axes, out_size):
    """Linear interpolation with the corner pixels aligned, one axis at a
    time (for every non-nearest mode, as the JAX package computes it)."""
    for ax, n_out in zip(axes, out_size):
        n_in = a.shape[ax]
        if n_in == n_out:
            continue
        pos = (torch.arange(n_out, device=a.device) * (n_in - 1)) \
            / max(n_out - 1, 1)
        lo = torch.floor(pos).long()
        hi = (lo + 1).clamp_max(n_in - 1)
        shape = [1] * a.dim()
        shape[ax] = n_out
        w = (pos - lo).to(a.dtype).reshape(shape)
        a = a.index_select(ax, lo) * (1 - w) + a.index_select(ax, hi) * w
    return a


def _resize_kernel(a, axes, out_size, kernel):
    for ax, n_out in zip(axes, out_size):
        n_in = a.shape[ax]
        if n_in == n_out:
            continue
        w = _resize_weights(n_in, n_out, kernel, a.device).to(a.dtype)
        a = torch.tensordot(a.movedim(ax, -1), w, dims=1).movedim(-1, ax)
    return a


_RESIZE = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
           "trilinear": "linear", "bicubic": "cubic", "area": "linear"}


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial dims to ``size`` (or by ``scale_factor``, the
    sizes floored) with the JAX package's rules: "nearest" takes
    floor((i + 0.5) * in / out); with ``align_corners`` every other mode
    is linear between aligned corners; otherwise linear (bilinear,
    trilinear, area) or Keys cubic (a = -0.5, bicubic) kernels over
    half-pixel centres, widened when shrinking (``jax.image.resize``).
    ``align_mode`` is accepted and, as there, not read."""
    method = _RESIZE[mode]
    channel_last = data_format in ("NHWC", "NWC", "NDHWC")
    nd = len(x.shape) - 2
    spatial = list(x.shape[1:-1] if channel_last else x.shape[2:])
    if size is not None:
        if isinstance(size, Tensor):
            size = [int(v) for v in size.numpy().tolist()]
        out_size = [int(s) for s in (size if isinstance(size, (list, tuple))
                                     else [size] * nd)]
    else:
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else [scale_factor] * nd)
        out_size = [int(spatial[i] * float(sf[i])) for i in range(nd)]
    axes = list(range(1, 1 + nd)) if channel_last else list(range(2, 2 + nd))

    def body(a):
        if method == "nearest":
            return _resize_nearest(a, axes, out_size)
        if align_corners:
            return _resize_align_corners(a, axes, out_size)
        return _resize_kernel(a, axes, out_size, _triangle
                              if method == "linear" else _keys_cubic)
    return call("interpolate", body, [x])


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    """``interpolate`` under Paddle's other name."""
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def _pads4(p):
    p = _pair(p)
    return [p[0], p[1], p[0], p[1]] if len(p) == 2 else p


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col of an NCHW input: (N, C * kh * kw, L). ``paddings`` is one
    value, [h, w] or [top, left, bottom, right]."""
    k, s, d, p = (_pair(kernel_sizes), _pair(strides), _pair(dilations),
                  _pads4(paddings))

    def body(a):
        a = TF.pad(a, (p[1], p[3], p[0], p[2]))
        return TF.unfold(a, k, dilation=d, stride=s)
    return call("unfold", body, [x])


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the inverse of ``unfold``: sums overlapping blocks of (N,
    C * kh * kw, L) into (N, C, H, W)."""
    out, k, s, d, p = (_pair(output_sizes), _pair(kernel_sizes),
                       _pair(strides), _pair(dilations), _pads4(paddings))

    def body(a):
        n, ckk, _ = a.shape
        c = ckk // (k[0] * k[1])
        ph, pw = out[0] + p[0] + p[2], out[1] + p[1] + p[3]
        oh = (ph - d[0] * (k[0] - 1) - 1) // s[0] + 1
        ow = (pw - d[1] * (k[1] - 1) - 1) // s[1] + 1
        a = a.reshape(n, c, k[0], k[1], oh, ow)
        result = a.new_zeros((n, c, ph, pw))
        for i in range(k[0]):
            for j in range(k[1]):
                hi, wj = i * d[0], j * d[1]
                result[:, :, hi:hi + oh * s[0]:s[0],
                       wj:wj + ow * s[1]:s[1]] += a[:, :, i, j]
        return result[:, :, p[0]:ph - p[2], p[1]:pw - p[3]]
    return call("fold", body, [x])


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    """(N, C r^2, H, W) -> (N, C, H r, W r)."""
    r = upscale_factor

    def body(a):
        if data_format == "NHWC":
            a = a.permute(0, 3, 1, 2)
        n, c, h, w = a.shape
        y = a.reshape(n, c // (r * r), r, r, h, w).permute(
            0, 1, 4, 2, 5, 3).reshape(n, c // (r * r), h * r, w * r)
        return y.permute(0, 2, 3, 1) if data_format == "NHWC" else y
    return call("pixel_shuffle", body, [x])


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    """(N, C, H r, W r) -> (N, C r^2, H, W), the inverse of
    ``pixel_shuffle``."""
    r = downscale_factor

    def body(a):
        if data_format == "NHWC":
            a = a.permute(0, 3, 1, 2)
        n, c, h, w = a.shape
        y = a.reshape(n, c, h // r, r, w // r, r).permute(
            0, 1, 3, 5, 2, 4).reshape(n, c * r * r, h // r, w // r)
        return y.permute(0, 2, 3, 1) if data_format == "NHWC" else y
    return call("pixel_unshuffle", body, [x])


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    """sum(a b) / max(|a| |b|, eps) over ``axis``."""
    def body(a, b):
        num = (a * b).sum(dim=axis)
        den = (torch.linalg.vector_norm(a, dim=axis)
               * torch.linalg.vector_norm(b, dim=axis)).clamp_min(eps)
        return num / den
    return call("cosine_similarity", body, [x1, x2])


def bilinear(x1, x2, weight, bias=None, name=None):
    """x1^T W_o x2 (+ b_o) for each output o: W is (out, in1, in2)."""
    def body(a, b, w, *bb):
        y = torch.einsum("bi,oij,bj->bo", a, w, b)
        return y + bb[0] if bb else y
    return call("bilinear", body, [t for t in (x1, x2, weight, bias)
                                   if t is not None])


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """(1 - epsilon) * label + epsilon * prior, the prior uniform over the
    last dim unless ``prior_dist`` is given."""
    def body(lab, *pd):
        if pd:
            return (1 - epsilon) * lab + epsilon * pd[0]
        return (1 - epsilon) * lab + epsilon / lab.shape[-1]
    return call("label_smooth", body, [t for t in (label, prior_dist)
                                       if t is not None])


def sequence_mask(lengths, maxlen=None, dtype="int64", name=None):
    """(..., maxlen) mask, 1 where the position is below the length, on
    the lengths' device. Without ``maxlen`` it is the largest length,
    read on the host."""
    if maxlen is None:
        maxlen = int(_payload(lengths).max())

    def body(lens):
        pos = torch.arange(maxlen, device=lens.device)
        return (pos < lens[..., None]).to(convert_dtype(dtype))
    return call("sequence_mask", body, [lengths], mask=[False])


__all__ = ["linear", "matmul", "dropout", "embedding", "channel_shuffle",
           "dropout2d", "dropout3d", "alpha_dropout", "embedding_bag",
           "one_hot", "pad", "zeropad2d", "interpolate", "upsample",
           "unfold", "fold", "pixel_shuffle", "pixel_unshuffle",
           "cosine_similarity", "bilinear", "label_smooth", "sequence_mask"]

register_module(sys.modules[__name__], "nn_common",
                skip=("one_hot", "pad", "unfold"))
