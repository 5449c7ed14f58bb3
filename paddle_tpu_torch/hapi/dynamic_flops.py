"""paddle.flops: per-layer FLOPs accounting through forward hooks
(counterpart of ``paddle_tpu/hapi/dynamic_flops.py``, the JAX package's
code; reference ``python/paddle/hapi/dynamic_flops.py``).

Leaf layers get a count function matched on their type, keyed on the
port's ``Layer`` classes (the JAX package's table, without
``SyncBatchNorm`` and ``ReLU6``, which the port does not have yet);
unknown types count zero with a notice, and
``custom_ops`` overrides. A multiply-accumulate counts as one op,
matching the reference's numbers.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["flops"]


def _numel(t):
    return int(np.prod(t.shape)) if t.shape else 1


def _count_convnd(m, x, y):
    # output elements × (in_ch/groups × prod(kernel)) MACs (+bias)
    bias_ops = 1 if getattr(m, "bias", None) is not None else 0
    macs_per_out = int(np.prod(m.weight.shape[1:]))
    m._flops_ops += _numel(y) * (macs_per_out + bias_ops)


def _count_linear(m, x, y):
    in_features = m.weight.shape[0]
    m._flops_ops += _numel(y) * in_features


def _count_bn(m, x, y):
    m._flops_ops += 2 * _numel(x[0] if isinstance(x, tuple) else x)


def _count_relu(m, x, y):
    m._flops_ops += _numel(x[0] if isinstance(x, tuple) else x)


def _count_avgpool(m, x, y):
    m._flops_ops += _numel(y)


def _count_adap_avgpool(m, x, y):
    xin = x[0] if isinstance(x, tuple) else x
    kern = max(_numel(xin) // max(_numel(y), 1), 1)
    m._flops_ops += (kern + 1) * _numel(y)


def _count_zero(m, x, y):
    pass


def _register_hooks() -> Dict[type, callable]:
    from .. import nn
    return {
        nn.Conv1D: _count_convnd, nn.Conv2D: _count_convnd,
        nn.Conv3D: _count_convnd,
        nn.Conv1DTranspose: _count_convnd, nn.Conv2DTranspose: _count_convnd,
        nn.Conv3DTranspose: _count_convnd,
        nn.Linear: _count_linear,
        nn.BatchNorm1D: _count_bn, nn.BatchNorm2D: _count_bn,
        nn.BatchNorm3D: _count_bn, nn.BatchNorm: _count_bn,
        nn.ReLU: _count_relu, nn.Sigmoid: _count_relu,
        nn.AvgPool1D: _count_avgpool, nn.AvgPool2D: _count_avgpool,
        nn.AvgPool3D: _count_avgpool,
        nn.AdaptiveAvgPool1D: _count_adap_avgpool,
        nn.AdaptiveAvgPool2D: _count_adap_avgpool,
        nn.AdaptiveAvgPool3D: _count_adap_avgpool,
        nn.Dropout: _count_zero,
    }


def flops(net, input_size=None, custom_ops: Optional[dict] = None,
          print_detail: bool = False, inputs=None):
    """Total FLOPs of one forward pass (reference hapi flops :28).

    ``input_size`` builds a zeros input of that shape on the current
    device; alternatively pass ``inputs`` (a Tensor) directly.
    """
    from ..core import dispatch
    from ..ops.creation import to_tensor

    if inputs is None:
        if input_size is None:
            raise ValueError("flops needs input_size or inputs")
        inputs = to_tensor(np.zeros(input_size, np.float32))

    custom_ops = custom_ops or {}
    table = _register_hooks()
    handles = []
    seen_types = set()
    leaves = [m for m in net.sublayers(include_self=True)
              if not list(m.children())]
    for m in leaves:
        m._flops_ops = 0
        m._flops_params = sum(_numel(p) for p in m.parameters())
        mt = type(m)
        fn = custom_ops.get(mt, table.get(mt))
        if fn is None:
            if mt not in seen_types:
                print(f"Cannot find suitable count function for {mt}. "
                      f"Treat it as zero FLOPs.")
            fn = _count_zero
        elif mt not in seen_types:
            src = "Customize Function" if mt in custom_ops else str(mt)
            print(f"{src}'s flops has been counted")
        seen_types.add(mt)
        handles.append(m.register_forward_post_hook(fn))

    was_training = net.training
    net.eval()
    try:
        with dispatch.no_grad():
            net(inputs)
    finally:
        for h in handles:
            h.remove()
        if was_training:
            net.train()

    total_ops = sum(m._flops_ops for m in leaves)
    total_params = sum(m._flops_params for m in leaves)
    if print_detail:
        print(f"{'Layer':<40}{'FLOPs':>16}{'Params':>12}")
        for m in leaves:
            print(f"{type(m).__name__:<40}{m._flops_ops:>16}"
                  f"{m._flops_params:>12}")
    print(f"Total Flops: {total_ops}     Total Params: {total_params}")
    return int(total_ops)
