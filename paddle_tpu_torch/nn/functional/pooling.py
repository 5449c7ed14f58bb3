"""Pooling (counterpart of ``paddle_tpu/nn/functional/pooling.py``).

The JAX package pools with ``lax.reduce_window`` (no Pallas kernel);
the port with torch's pooling ops, plain ops here as there. The JAX
package's window rules are kept where torch's differ:

- ``ceil_mode`` adds high padding so that a last window exists whenever
  ``(size + pads - k) % stride != 0``, even one that starts in the
  padding; torch's ``ceil_mode`` drops such a window. So the port never
  uses torch's ``ceil_mode``: it pads explicitly (-inf for max, zeros
  for the average) and pools with ``padding=0``.
- ``exclusive=True`` divides by the count of real elements in the
  window, ``exclusive=False`` by ``prod(kernel_size)``, over the ceil
  overflow too (torch's ``count_include_pad`` counts only up to the
  padded edge). The explicit path sums the window and divides by a count
  pooled over ones.
- Torch's own padding is taken only where it says the same: symmetric
  pads of at most half the window, and no ceil overflow.
- ``return_mask`` gives the flat spatial index into the unpadded input,
  the first maximum of a window in row-major order (torch's choice on
  ties; XLA's depends on how it lowers the padded window, so the JAX
  package's differs there on tied values only), -1 for a window of
  padding only, int32; with a channel-last input the mask is
  channel-first, as the JAX package returns it.
- Adaptive bins run from ``floor(i·in/out)`` to ``ceil((i+1)·in/out)``,
  torch's bins too. ``adaptive_max_pool*d`` with ``return_mask`` gives
  ``(out, None)``, as in the JAX package; its gradient goes to the
  window's first maximum (the JAX ``jnp.max`` splits it among ties).

On Paddle ``Tensor``s each entry is one op through
``core.dispatch.call`` under the JAX package's op name; on
``torch.Tensor``s, the same body as a torch-level function.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as TF

from ...core import dispatch
from ...core.generator import default_generator
from ...core.tensor import Tensor, as_tensor
from .conv import _ntuple, _resolve_padding, pad_arg, same_pads

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}
_ADAPTIVE = {("avg", 1): TF.adaptive_avg_pool1d,
             ("avg", 2): TF.adaptive_avg_pool2d,
             ("avg", 3): TF.adaptive_avg_pool3d,
             ("max", 1): TF.adaptive_max_pool1d,
             ("max", 2): TF.adaptive_max_pool2d,
             ("max", 3): TF.adaptive_max_pool3d}


def _t(x):
    return x if isinstance(x, Tensor) else as_tensor(x)


def _run(op_name, body, x, differentiable=True, export_attrs=None):
    """``body`` on a torch.Tensor, or one dispatched op on a Paddle
    Tensor (``export_attrs()`` goes to the export hooks)."""
    if isinstance(x, torch.Tensor):
        return body(x)
    return dispatch.call(op_name, body, [_t(x)],
                         differentiable_mask=None if differentiable
                         else [False], export_attrs=export_attrs)


def _window_pads(spatial, ksize, stride, padding, nd, ceil_mode
                 ) -> List[Tuple[int, int]]:
    """The (low, high) pads of each spatial dim, the JAX package's:
    'SAME' and 'VALID' ignore ``ceil_mode``; explicit pads with it grow
    the high pad until the last window fits."""
    pad = _resolve_padding(padding, nd)
    if pad == "VALID":
        return [(0, 0)] * nd
    if pad == "SAME":
        return same_pads(spatial, ksize, stride)
    out = []
    for n, k, s, (lo, hi) in zip(spatial, ksize, stride, pad):
        if ceil_mode:
            rem = (n + lo + hi - k) % s
            if rem:
                hi += s - rem
        out.append((lo, hi))
    return out


def _torch_pads(pads, ksize) -> Optional[List[int]]:
    """The symmetric pads torch's own pooling applies identically, or
    None."""
    if all(lo == hi and 0 <= lo <= k // 2 for (lo, hi), k
           in zip(pads, ksize)):
        return [lo for lo, _ in pads]
    return None


def _window_sum(a, ksize, stride, nd):
    """The sum of each window of an already padded ``a``."""
    if nd == 1:
        return TF.avg_pool2d(a.unsqueeze(-2), (1, ksize[0]), (1, stride[0]),
                             divisor_override=1).squeeze(-2)
    return _AVG[nd](a, ksize, stride, divisor_override=1)


def _pool_body(a, ksize, stride, padding, nd, channel_last, mode,
               exclusive, ceil_mode):
    a = a.movedim(-1, 1) if channel_last else a
    pads = _window_pads(a.shape[2:], ksize, stride, padding, nd, ceil_mode)
    direct = _torch_pads(pads, ksize)
    if mode == "max":
        if direct is not None:
            y = _MAX[nd](a, ksize, stride, direct)
        else:
            low = (-math.inf if a.is_floating_point()
                   else torch.iinfo(a.dtype).min)
            y = _MAX[nd](TF.pad(a, pad_arg(pads), value=low), ksize, stride)
    elif direct is not None:
        y = _AVG[nd](a, ksize, stride, direct,
                     count_include_pad=not exclusive)
    else:
        s = _window_sum(TF.pad(a, pad_arg(pads)), ksize, stride, nd)
        if exclusive:
            ones = torch.ones((1, 1) + tuple(a.shape[2:]), dtype=a.dtype,
                              device=a.device)
            y = s / _window_sum(TF.pad(ones, pad_arg(pads)), ksize, stride,
                                nd)
        else:
            y = s / float(np.prod(ksize))
    return y.movedim(1, -1) if channel_last else y


def _pool_nd(x, kernel_size, stride, padding, nd, channel_last, mode,
             exclusive=True, ceil_mode=False, op_name="pool"):
    ksize = _ntuple(kernel_size, nd)
    stride = _ntuple(stride if stride is not None else ksize, nd)
    def export():
        return {"kernel_size": ksize, "stride": stride,
                "padding": _resolve_padding(padding, nd), "mode": mode,
                "exclusive": exclusive, "ceil_mode": ceil_mode,
                "channel_last": channel_last}
    return _run(op_name, lambda a: _pool_body(
        a, ksize, stride, padding, nd, channel_last, mode, exclusive,
        ceil_mode), x, export_attrs=export)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    """1D average pooling, NCL."""
    return _pool_nd(x, kernel_size, stride, padding, 1, False, "avg",
                    exclusive, ceil_mode, "avg_pool1d")


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    """2D average pooling, NCHW; ``divisor_override`` divides each
    window's sum by it instead (the JAX package's: the non-exclusive
    mean times ``prod(kernel_size) / divisor_override``)."""
    if divisor_override is not None:
        t = _pool_nd(x, kernel_size, stride, padding, 2,
                     data_format == "NHWC", "avg", False, ceil_mode,
                     "avg_pool2d")
        k = float(np.prod(_ntuple(kernel_size, 2)))
        return _run("scale", lambda a: a * (k / divisor_override), t)
    return _pool_nd(x, kernel_size, stride, padding, 2,
                    data_format == "NHWC", "avg", exclusive, ceil_mode,
                    "avg_pool2d")


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    """3D average pooling, NCDHW. ``divisor_override`` is accepted and
    ignored, as in the JAX package."""
    return _pool_nd(x, kernel_size, stride, padding, 3,
                    data_format == "NDHWC", "avg", exclusive, ceil_mode,
                    "avg_pool3d")


def _max_pool(x, kernel_size, stride, padding, return_mask, ceil_mode, nd,
              channel_last, op_name):
    out = _pool_nd(x, kernel_size, stride, padding, nd, channel_last, "max",
                   ceil_mode=ceil_mode, op_name=op_name)
    if return_mask:
        return out, _max_pool_indices(x, kernel_size, stride, padding, nd,
                                      channel_last, ceil_mode)
    return out


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    """1D max pooling, NCL; with ``return_mask`` also the argmax mask."""
    return _max_pool(x, kernel_size, stride, padding, return_mask,
                     ceil_mode, 1, False, "max_pool1d")


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    """2D max pooling, NCHW; with ``return_mask`` also the argmax mask."""
    return _max_pool(x, kernel_size, stride, padding, return_mask,
                     ceil_mode, 2, data_format == "NHWC", "max_pool2d")


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    """3D max pooling, NCDHW; with ``return_mask`` also the argmax mask."""
    return _max_pool(x, kernel_size, stride, padding, return_mask,
                     ceil_mode, 3, data_format == "NDHWC", "max_pool3d")


def _max_pool_indices(x, kernel_size, stride, padding, nd, channel_last,
                      ceil_mode=False):
    """Flat spatial argmax of each window into the unpadded input
    (int32, channel-first; -1 where a window holds padding only).
    'SAME'/'VALID' pad nothing here, as in the JAX package."""
    ksize = _ntuple(kernel_size, nd)
    stride_t = _ntuple(stride if stride is not None else kernel_size, nd)
    if isinstance(_resolve_padding(padding, nd), str):
        padding = 0

    def f(a):
        a = a.movedim(-1, 1) if channel_last else a
        spatial = tuple(a.shape[2:])
        pads = _window_pads(spatial, ksize, stride_t, padding, nd,
                            ceil_mode)
        padded = TF.pad(a, pad_arg(pads), value=-math.inf)
        _, idx = _MAX[nd](padded, ksize, stride_t, return_indices=True)
        # padded flat index -> coordinates -> flat index of the input
        pshape = padded.shape[2:]
        flat = torch.zeros_like(idx)
        valid = torch.ones_like(idx, dtype=torch.bool)
        rest = idx
        for i in reversed(range(nd)):
            coord = rest % pshape[i] - pads[i][0]
            rest = rest // pshape[i]
            valid &= (coord >= 0) & (coord < spatial[i])
            flat = flat + coord * int(np.prod(spatial[i + 1:]))
        return torch.where(valid, flat, -1).to(torch.int32)
    return _run("max_pool_mask", f, x, differentiable=False)


def _adaptive_pool_nd(x, output_size, nd, channel_last, mode, op_name):
    out = _ntuple(output_size, nd) if output_size is not None else None

    def f(a):
        a = a.movedim(-1, 1) if channel_last else a
        osize = tuple(o if o is not None else a.shape[2 + i]
                      for i, o in enumerate(out))
        y = _ADAPTIVE[(mode, nd)](a, osize)
        return y.movedim(1, -1) if channel_last else y
    return _run(op_name, f, x, export_attrs=lambda: {
        "output_size": output_size, "mode": mode,
        "channel_last": channel_last})


def adaptive_avg_pool1d(x, output_size, name=None):
    """Average pool to a target output length."""
    return _adaptive_pool_nd(x, output_size, 1, False, "avg",
                             "adaptive_avg_pool1d")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Average pool to a target (H, W); a None entry keeps that size."""
    return _adaptive_pool_nd(x, output_size, 2, data_format == "NHWC",
                             "avg", "adaptive_avg_pool2d")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    """Average pool to a target (D, H, W)."""
    return _adaptive_pool_nd(x, output_size, 3, data_format == "NDHWC",
                             "avg", "adaptive_avg_pool3d")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    """Max pool to a target output length."""
    out = _adaptive_pool_nd(x, output_size, 1, False, "max",
                            "adaptive_max_pool1d")
    return (out, None) if return_mask else out


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    """Max pool to a target (H, W)."""
    out = _adaptive_pool_nd(x, output_size, 2, False, "max",
                            "adaptive_max_pool2d")
    return (out, None) if return_mask else out


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    """Max pool to a target (D, H, W)."""
    out = _adaptive_pool_nd(x, output_size, 3, False, "max",
                            "adaptive_max_pool3d")
    return (out, None) if return_mask else out


def _max_unpool_nd(x, indices, kernel_size, stride, padding, nd,
                   output_size, op_name):
    """Scatter pooled values back to their flat spatial ``indices`` (from
    ``max_poolNd(return_mask=True)``) in a zero tensor."""
    ksize = _ntuple(kernel_size, nd)
    stride_t = _ntuple(stride if stride is not None else kernel_size, nd)
    pad = _ntuple(padding, nd)
    in_spatial = list(x.shape[2:])
    if output_size is None:
        out_spatial = tuple((in_spatial[i] - 1) * stride_t[i] - 2 * pad[i]
                            + ksize[i] for i in range(nd))
    else:
        out_spatial = tuple(output_size[-nd:])

    def f(a, idx):
        n, c = a.shape[:2]
        av = a.reshape(n * c, -1)
        iv = idx.reshape(n * c, -1).long()
        out = torch.zeros((n * c, int(np.prod(out_spatial))), dtype=a.dtype,
                          device=a.device)
        return out.scatter(1, iv, av).reshape((n, c) + out_spatial)
    if isinstance(x, torch.Tensor):
        return f(x, indices)
    return dispatch.call(op_name, f, [_t(x), _t(indices)],
                         differentiable_mask=[True, False])


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    """Scatter pooled values back to their argmax positions, 1D."""
    return _max_unpool_nd(x, indices, kernel_size, stride, padding, 1,
                          output_size, "max_unpool1d")


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    """Scatter pooled values back to their argmax positions, 2D."""
    return _max_unpool_nd(x, indices, kernel_size, stride, padding, 2,
                          output_size, "max_unpool2d")


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    """Scatter pooled values back to their argmax positions, 3D."""
    return _max_unpool_nd(x, indices, kernel_size, stride, padding, 3,
                          output_size, "max_unpool3d")


def _fractional_intervals(u, in_size, out_size, pool_size):
    """Pseudo-random pooling-region starts (Graham, Fractional
    Max-Pooling), the JAX package's sequence rule."""
    starts = np.zeros(out_size, dtype=np.int64)
    if out_size > 1:
        alpha = (in_size - pool_size) / (out_size - 1)
        i = np.arange(out_size - 1)
        starts[:-1] = ((i + u) * alpha).astype(np.int64) - int(u * alpha)
    starts[out_size - 1] = in_size - pool_size
    return starts


def _fractional_max_pool_nd(x, output_size, kernel_size, random_u, nd,
                            return_mask, op_name):
    """One gather and running max a kernel offset; the flat argmax beside
    it (the first offset wins a tie). Without ``random_u`` the offset
    ``u`` is drawn from the device's Paddle-API generator."""
    out_sz = _ntuple(output_size, nd)
    in_spatial = list(x.shape[2:])
    if kernel_size is None:
        ksize = tuple(in_spatial[i] // out_sz[i] for i in range(nd))
    else:
        ksize = _ntuple(kernel_size, nd)
    if random_u is None:
        dev = (x if isinstance(x, torch.Tensor) else _t(x)._data).device
        u = float(torch.rand((), generator=default_generator(dev),
                             device=dev))
    else:
        u = float(random_u)
    starts = [_fractional_intervals(u, in_spatial[i], out_sz[i], ksize[i])
              for i in range(nd)]

    def f(a):
        idx_axes = [torch.as_tensor(s, device=a.device) for s in starts]
        out = mask = None
        for off in np.ndindex(*ksize):
            v = a
            flat = 0
            for i in range(nd):
                cc = idx_axes[i] + off[i]
                v = v.index_select(2 + i, cc)
                flat = flat * in_spatial[i] + cc.reshape(
                    (-1,) + (1,) * (nd - 1 - i))
            flat = torch.broadcast_to(flat, v.shape)
            if out is None:
                out, mask = v, flat
            else:
                mask = torch.where(v > out, flat, mask)
                out = torch.maximum(out, v)
        return out, mask.to(torch.int32)
    if isinstance(x, torch.Tensor):
        out, mask = f(x)
    else:
        out, mask = dispatch.call(op_name, f, [_t(x)])
    return (out, mask) if return_mask else out


def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    """Max pool over pseudo-random fractional intervals, 2D."""
    return _fractional_max_pool_nd(x, output_size, kernel_size, random_u, 2,
                                   return_mask, "fractional_max_pool2d")


def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    """Max pool over pseudo-random fractional intervals, 3D."""
    return _fractional_max_pool_nd(x, output_size, kernel_size, random_u, 3,
                                   return_mask, "fractional_max_pool3d")


def _lp_pool(x, norm_type, kernel_size, stride, padding, nd, ceil_mode,
             data_format, op_name):
    """(sum |x|^p)^(1/p) over each window; p = inf is the max pool."""
    p = float(norm_type)
    channel_last = data_format in ("NHWC", "NLC")
    if p == math.inf:
        return _pool_nd(x, kernel_size, stride, padding, nd, channel_last,
                        "max", ceil_mode=ceil_mode, op_name=op_name)
    powed = _run(op_name + "_pow", lambda a: torch.abs(a) ** p, x)
    s = _pool_nd(powed, kernel_size, stride, padding, nd, channel_last,
                 "avg", exclusive=False, ceil_mode=ceil_mode, op_name=op_name)
    k = float(np.prod(_ntuple(kernel_size, nd)))
    return _run(op_name + "_root", lambda a: (a * k) ** (1.0 / p), s)


def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL", name=None):
    """Lp-norm pooling, 1D."""
    return _lp_pool(x, norm_type, kernel_size, stride, padding, 1, ceil_mode,
                    data_format, "lp_pool1d")


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    """Lp-norm pooling, 2D."""
    return _lp_pool(x, norm_type, kernel_size, stride, padding, 2, ceil_mode,
                    data_format, "lp_pool2d")


__all__ = [
    "avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d", "max_pool2d",
    "max_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
    "adaptive_avg_pool3d", "adaptive_max_pool1d", "adaptive_max_pool2d",
    "adaptive_max_pool3d", "max_unpool1d", "max_unpool2d", "max_unpool3d",
    "fractional_max_pool2d", "fractional_max_pool3d", "lp_pool1d",
    "lp_pool2d",
]
