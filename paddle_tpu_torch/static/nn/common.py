"""``static.nn``'s layer helpers for construct-then-execute code
(counterpart of ``paddle_tpu/static/nn/common.py``; reference
python/paddle/static/nn/common.py).

Each helper makes its layer at build time and calls it once: the
layer's parameters are created then (the port's initializers dispatch no
op, so nothing of their making is recorded) and the enclosing
``Program`` captures them, reading them live at every run.

``sparse_embedding`` needs the parameter-server runtime
(``distributed/ps``), which the port does not have yet: it raises.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ... import nn as _nn
from ...core import dispatch as _dispatch
from ...core.dtype import convert_dtype
from ...core.place import current_device
from ...core.tensor import Tensor, as_tensor

__all__ = ["fc", "embedding", "sparse_embedding", "conv2d", "batch_norm",
           "layer_norm", "instance_norm", "spectral_norm", "py_func",
           "ExponentialMovingAverage"]


def fc(x, size, num_flatten_dims=1, activation=None, name=None,
       weight_attr=None, bias_attr=None):
    """A fully-connected layer over the trailing dims from
    ``num_flatten_dims`` on (reference common.py fc); ``bias_attr=False``
    drops the bias. The flatten takes its shape from the run's input, so
    the program stays batch-polymorphic."""
    in_features = 1
    for s in x.shape[num_flatten_dims:]:
        in_features *= int(s)
    layer = _nn.Linear(in_features, size, weight_attr=weight_attr,
                       bias_attr=bias_attr)
    h = x.flatten(start_axis=num_flatten_dims) \
        if num_flatten_dims < len(x.shape) - 1 else x
    out = layer(h)
    if activation == "relu":
        out = _nn.functional.relu(out)
    elif activation == "tanh":
        out = out.tanh()
    elif activation == "sigmoid":
        out = out.sigmoid()
    elif activation is not None:
        raise ValueError(f"unsupported activation {activation!r}")
    return out


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32"):
    """A lookup table of ``size`` = [rows, width] (reference common.py
    embedding); ``dtype`` is the table's. ``is_sparse`` is a hint about
    gradient storage the port does not need."""
    layer = _nn.Embedding(size[0], size[1], padding_idx=padding_idx,
                          weight_attr=param_attr)
    want = convert_dtype(str(dtype).replace("paddle.", ""))
    if layer.weight.dtype != want:
        layer.to(dtype=want)
    return layer(input)


def sparse_embedding(input, size, padding_idx=None, is_test=False,
                     entry=None, table_class="MemorySparseTable",
                     param_attr=None, dtype="float32", slot=None):
    """The parameter-server embedding (reference common.py:3691): its
    table lives on the parameter servers of ``distributed/ps``, which the
    port does not have yet (ROADMAP)."""
    raise NotImplementedError(
        "static.nn.sparse_embedding needs the parameter-server runtime "
        "(distributed/ps), which the port does not have yet")


def _act(out, activation):
    if activation is None:
        return out
    fn = getattr(_nn.functional, activation, None)
    if fn is None:
        raise ValueError(f"unsupported activation {activation!r}")
    return fn(out)


def conv2d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=1, param_attr=None, bias_attr=None,
           act=None, data_format="NCHW", name=None):
    """A 2-D convolution (reference common.py conv2d:779)."""
    in_channels = int(input.shape[1 if data_format == "NCHW" else -1])
    layer = _nn.Conv2D(in_channels, num_filters, filter_size,
                       stride=stride, padding=padding, dilation=dilation,
                       groups=groups, weight_attr=param_attr,
                       bias_attr=bias_attr, data_format=data_format)
    return _act(layer(input), act)


def batch_norm(input, act=None, is_test=False, momentum=0.9,
               epsilon=1e-5, param_attr=None, bias_attr=None,
               data_layout="NCHW", name=None):
    """Batch norm over the channels (reference common.py batch_norm:2616).
    With ``is_test`` the running statistics normalize and stay as they
    are; otherwise the batch's normalize and update them, at build time
    and at every run."""
    num_channels = int(input.shape[1 if data_layout == "NCHW" else -1])
    layer = _nn.BatchNorm(num_channels, momentum=momentum,
                          epsilon=epsilon, weight_attr=param_attr,
                          bias_attr=bias_attr, data_format=data_layout)
    if is_test:
        layer.eval()
    return _act(layer(input), act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    """Layer norm over the dims from ``begin_norm_axis`` on (reference
    common.py layer_norm:3555)."""
    shape = [int(s) for s in input.shape[begin_norm_axis:]]
    layer = _nn.LayerNorm(shape, epsilon=epsilon,
                          weight_attr=param_attr if scale else False,
                          bias_attr=bias_attr if shift else False)
    return _act(layer(input), act)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    """Instance norm of an NCHW input (reference common.py
    instance_norm:271)."""
    layer = _nn.InstanceNorm2D(int(input.shape[1]), epsilon=epsilon,
                               weight_attr=param_attr, bias_attr=bias_attr)
    return layer(input)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """``weight`` over its largest singular value, by power iteration
    (reference common.py spectral_norm:3417)."""
    layer = _nn.SpectralNorm(list(weight.shape), dim=dim,
                             power_iters=power_iters, epsilon=eps)
    return layer(weight)


def _host_call(fn, templates, arrays):
    """``fn`` on host numpy copies of ``arrays``; its results as tensors
    of ``templates``' (shape, dtype) on the arrays' device."""
    device = arrays[0].device if arrays else current_device()
    res = fn(*[a.detach().float().cpu().numpy()
               if a.dtype == torch.bfloat16 else a.detach().cpu().numpy()
               for a in arrays])
    rs = res if isinstance(res, (list, tuple)) else [res]
    return tuple(torch.as_tensor(np.asarray(r)).reshape(shape).to(
        device=device, dtype=dtype) for r, (shape, dtype) in zip(rs,
                                                                 templates))


class _PyFunc(torch.autograd.Function):
    """py_func with a ``backward_func``: the forward callback, and a
    backward that calls ``backward_func`` with the outputs' gradients
    only."""

    @staticmethod
    def forward(ctx, func, backward_func, in_templates, out_templates,
                *arrays):
        ctx.backward_func = backward_func
        ctx.in_templates = in_templates
        return _host_call(func, out_templates, arrays)

    @staticmethod
    def backward(ctx, *grads):
        got = _host_call(ctx.backward_func, ctx.in_templates, grads)
        return (None, None, None, None) + got


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """Run the host function ``func`` on numpy copies of ``x`` inside the
    graph (reference common.py py_func:3118): one op, which a program
    replays, calling ``func`` at every run. ``out`` is a template Tensor
    (or a list of them) giving the results' shapes and dtypes.
    ``backward_func`` receives only the outputs' gradients, one for each
    output in order, and returns one gradient for each input; it is not
    handed the forward inputs and outputs, so
    ``skip_vars_in_backward_input`` has nothing to skip and raises (close
    over the forward values instead), as in the JAX package."""
    if skip_vars_in_backward_input is not None:
        raise NotImplementedError(
            "py_func: backward_func here receives only the upstream "
            "output gradients; skip_vars_in_backward_input is not "
            "applicable — close over any forward values you need")
    xs = x if isinstance(x, (list, tuple)) else [x]
    xs = [v if isinstance(v, Tensor) else as_tensor(v) for v in xs]
    outs = out if isinstance(out, (list, tuple)) else [out]
    out_templates = tuple((tuple(o.shape), o.dtype) for o in outs)
    in_templates = tuple((tuple(v.shape), v.dtype) for v in xs)
    multi = isinstance(out, (list, tuple))

    def f(*arrays):
        if backward_func is None:
            res = _host_call(func, out_templates, arrays)
        else:
            res = _PyFunc.apply(func, backward_func, in_templates,
                                out_templates, *arrays)
        return list(res) if multi else res[0]

    return _dispatch.call("py_func", f, xs)


class ExponentialMovingAverage:
    """Shadow copies of the trainable parameters (reference
    common.py:4040): ``shadow = decay * shadow + (1 - decay) * param`` at
    every ``update()``; ``apply()`` writes the shadows into the
    parameters for evaluation (as a context manager it restores them on
    exit, else ``restore()`` does). ``thres_steps`` ramps the decay:
    ``min(decay, (1 + t) / (10 + t))``. The parameters keep their payloads,
    which an optimizer holds: the values are copied in and out."""

    def __init__(self, decay=0.999, thres_steps=None, parameters=None,
                 name=None):
        if parameters is None:
            raise ValueError(
                "ExponentialMovingAverage needs the parameter list "
                "(dygraph-first design: there is no global program to "
                "collect them from)")
        self._decay = float(decay)
        self._thres_steps = thres_steps
        self._params = [p for p in parameters if not p.stop_gradient]
        self._shadow = [p._data.detach().clone() for p in self._params]
        self._backup = None
        self._step = 0

    def update(self):
        self._step += 1
        d = self._decay
        if self._thres_steps is not None:
            d = min(d, (1.0 + self._step) / (10.0 + self._step))
        with torch.no_grad():
            self._shadow = [(d * s + (1.0 - d) * p._data).to(p._data.dtype)
                            for s, p in zip(self._shadow, self._params)]

    def apply(self, executor=None, need_restore=True):
        if self._backup is not None:
            raise RuntimeError(
                "ExponentialMovingAverage.apply() called while shadows "
                "are already applied — a second backup would capture the "
                "shadow values and lose the training weights; call "
                "restore() first")
        self._backup = [p._data.detach().clone() for p in self._params]
        with torch.no_grad():
            for p, s in zip(self._params, self._shadow):
                p._data.copy_(s)

        @contextlib.contextmanager
        def ctx():
            try:
                yield self
            finally:
                if need_restore:
                    self.restore()
        return ctx()

    def restore(self, executor=None):
        if self._backup is None:
            return
        with torch.no_grad():
            for p, b in zip(self._params, self._backup):
                p._data.copy_(b)
        self._backup = None
