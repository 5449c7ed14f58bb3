"""Convolutions (counterpart of ``paddle_tpu/nn/functional/conv.py``).

The JAX package lowers every convolution to one XLA
``conv_general_dilated``; the port calls torch's convolution (cuDNN on
the card). Neither is a hand-written kernel: the JAX package has no
Pallas kernel here. Layouts are Paddle's: NCHW input, OIHW weight, and
IOHW for the transposes (torch's layouts too); ``data_format="NHWC"``
(``NLC``, ``NDHWC``) moves the channel axis around the op.

Paddle's padding forms are resolved as the JAX package resolves them:
an int, one int a spatial dim, per-dim (low, high) pairs, a flat list of
2·nd values (asymmetric), ``'SAME'`` and ``'VALID'``. ``'SAME'`` is
XLA's: ``total = max((ceil(in/stride) - 1)·stride + dilated_k - in, 0)``
with ``total // 2`` before and the rest after, for any stride. torch's
own ``padding='same'`` refuses stride > 1 and takes no asymmetric pairs,
so padding that is not one symmetric int a dim is applied with
``F.pad`` and the convolution runs with ``padding=0``.

On Paddle ``Tensor``s each entry is one op through
``core.dispatch.call`` under the JAX package's op name (``conv2d`` and
the others are on amp's white list); on ``torch.Tensor``s, the same
body as a torch-level function after ``amp_cast``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch.nn import functional as TF

from ...amp.state import amp_cast
from ...core import dispatch
from ...core.tensor import Tensor, as_tensor

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _ntuple(v, n) -> Tuple[int, ...]:
    if isinstance(v, (list, tuple)):
        if len(v) == n:
            return tuple(int(x) for x in v)
        if len(v) == 1:
            return tuple(int(v[0]) for _ in range(n))
        raise ValueError(f"expected {n} values, got {v}")
    return tuple(int(v) for _ in range(n))


def _resolve_padding(padding, nd):
    """'SAME'/'VALID', or a list of nd (low, high) pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, (list, tuple)):
        flat = list(padding)
        if len(flat) == nd and all(isinstance(p, (list, tuple))
                                   for p in flat):
            return [tuple(int(v) for v in p) for p in flat]
        if len(flat) == 2 * nd:
            return [(int(flat[2 * i]), int(flat[2 * i + 1]))
                    for i in range(nd)]
        return [(x, x) for x in _ntuple(flat, nd)]
    return [(x, x) for x in _ntuple(padding, nd)]


def same_pads(spatial: Sequence[int], window: Sequence[int],
              stride: Sequence[int]) -> List[Tuple[int, int]]:
    """XLA's 'SAME' (low, high) pads for an (effective) window."""
    pads = []
    for n, k, s in zip(spatial, window, stride):
        out = -(-n // s)
        total = max((out - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def pad_arg(pads: Sequence[Tuple[int, int]]) -> List[int]:
    """(low, high) pairs, first spatial dim first, as ``F.pad`` takes
    them (last dim first)."""
    out: List[int] = []
    for lo, hi in reversed(list(pads)):
        out += [lo, hi]
    return out


def _t(x):
    return x if isinstance(x, Tensor) else as_tensor(x)


def _channel_first(a: torch.Tensor, channel_last: bool) -> torch.Tensor:
    return a.movedim(-1, 1) if channel_last else a


def _add_bias(y: torch.Tensor, b) -> torch.Tensor:
    if b is None:
        return y
    return y + b.to(y.dtype).reshape((1, -1) + (1,) * (y.dim() - 2))


def _conv_body(a, w, b, stride, padding, dilation, groups, nd,
               channel_last):
    stride = _ntuple(stride, nd)
    dilation = _ntuple(dilation, nd)
    a = _channel_first(a, channel_last)
    w = w.to(a.dtype)
    pad = _resolve_padding(padding, nd)
    if pad == "VALID":
        pad = [(0, 0)] * nd
    elif pad == "SAME":
        window = [d * (k - 1) + 1 for d, k in zip(dilation, w.shape[2:])]
        pad = same_pads(a.shape[2:], window, stride)
    if all(lo == hi and lo >= 0 for lo, hi in pad):
        y = _CONV[nd](a, w, None, stride, [lo for lo, _ in pad], dilation,
                      groups)
    else:
        y = _CONV[nd](TF.pad(a, pad_arg(pad)), w, None, stride, 0,
                      dilation, groups)
    y = _add_bias(y, b)
    return y.movedim(1, -1) if channel_last else y


def _run(op_name, body, x, weight, bias, export_attrs=None):
    """``body(x, weight, bias)`` on torch.Tensors (after ``amp_cast``), or
    one dispatched op on Paddle Tensors (``export_attrs()`` goes to the
    export hooks)."""
    if isinstance(x, torch.Tensor):
        return body(*amp_cast(op_name, x, weight, bias))
    ins = [_t(x), _t(weight)] + ([] if bias is None else [_t(bias)])
    return dispatch.call(op_name, lambda a, w, *b: body(
        a, w, b[0] if b else None), ins, export_attrs=export_attrs)


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, nd,
             channel_last, op_name):
    def export():
        return {"stride": _ntuple(stride, nd),
                "padding": _resolve_padding(padding, nd),
                "dilation": _ntuple(dilation, nd), "groups": groups,
                "channel_last": channel_last}
    return _run(op_name, lambda a, w, b: _conv_body(
        a, w, b, stride, padding, dilation, groups, nd, channel_last),
        x, weight, bias, export)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    """1D convolution, NCL (NLC with ``data_format``); weight (O, I/g, K)."""
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    data_format == "NLC", "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2D convolution, NCHW (NHWC with ``data_format``); weight
    (O, I/g, KH, KW); ``groups`` splits the channels."""
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format == "NHWC", "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    """3D convolution, NCDHW (NDHWC with ``data_format``)."""
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    data_format == "NDHWC", "conv3d")


def _conv_transpose_body(a, w, b, stride, padding, output_padding, dilation,
                         groups, nd, channel_last, output_size):
    """The JAX package's transposed convolution: output length
    ``(in - 1)·stride + dilation·(k - 1) + 1 - low - high +
    output_padding`` a dim. torch's transpose with no padding gives the
    full ``(in - 1)·stride + dilation·(k - 1) + 1``; the pads crop it
    (and a negative crop, an output padding past ``high``, adds zeros),
    except where torch's own symmetric ``padding``/``output_padding``
    say the same."""
    stride = _ntuple(stride, nd)
    dilation = _ntuple(dilation, nd)
    output_padding = _ntuple(output_padding, nd)
    a = _channel_first(a, channel_last)
    w = w.to(a.dtype)
    ksize = [int(k) for k in w.shape[2:]]
    pad = _resolve_padding(padding, nd)
    if pad == "VALID":
        pad = [(0, 0)] * nd
    elif pad == "SAME":          # out = in * stride
        pad = []
        for i in range(nd):
            total = max(dilation[i] * (ksize[i] - 1) + 1 - stride[i], 0)
            pad.append((total // 2, total - total // 2))
    if output_size is not None:
        output_size = _ntuple(output_size, nd)
        output_padding = tuple(
            output_size[i] - ((a.shape[2 + i] - 1) * stride[i]
                              - pad[i][0] - pad[i][1]
                              + dilation[i] * (ksize[i] - 1) + 1)
            for i in range(nd))
    if all(lo == hi and lo >= 0 and 0 <= op < max(s, d)
           for (lo, hi), op, s, d in zip(pad, output_padding, stride,
                                         dilation)):
        y = _CONV_T[nd](a, w, None, stride, [lo for lo, _ in pad],
                        list(output_padding), groups, dilation)
    else:
        y = _CONV_T[nd](a, w, None, stride, 0, 0, groups, dilation)
        y = TF.pad(y, pad_arg([(-lo, op - hi) for (lo, hi), op
                               in zip(pad, output_padding)]))
    y = _add_bias(y, b)
    return y.movedim(1, -1) if channel_last else y


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       dilation, groups, nd, channel_last, output_size,
                       op_name):
    return _run(op_name, lambda a, w, b: _conv_transpose_body(
        a, w, b, stride, padding, output_padding, dilation, groups, nd,
        channel_last, output_size), x, weight, bias)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCL", name=None):
    """1D transposed convolution; weight (I, O/g, K)."""
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 1,
                              data_format == "NLC", output_size,
                              "conv1d_transpose")


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCHW", name=None):
    """2D transposed convolution; weight (I, O/g, KH, KW); ``output_size``
    sets the output padding."""
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 2,
                              data_format == "NHWC", output_size,
                              "conv2d_transpose")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCDHW", name=None):
    """3D transposed convolution; weight (I, O/g, KD, KH, KW)."""
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 3,
                              data_format == "NDHWC", output_size,
                              "conv3d_transpose")


__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]
