"""paddle.quantization — PTQ/QAT (counterpart of
``paddle_tpu/quantization/__init__.py``).

Reference: python/paddle/quantization/ (QuantConfig config.py, PTQ
ptq.py, QAT qat.py) and the weight_quantize/weight_dequantize,
weight_only_linear and llm_int8_linear ops of phi. int8 abs-max weight
quantization per output channel (the last dim of Paddle's (in, out)
weight), a dequantizing ``QuantedLinear`` for weight-only PTQ, and
fake-quant QAT through a straight-through estimator. The JAX package
computes all of this outside any Pallas kernel, and so does the port:
each op is plain torch behind ``core.dispatch.call``.

One difference from the JAX package: a ``QuantedLinear`` registers its
int8 weight and its scales as buffers, so they are in its
``state_dict`` and in a ``jit.save``'s ``.pdparams``; the JAX
``QuantedLinear`` holds them as plain attributes, which its exported
program bakes in as constants.
"""
from __future__ import annotations

import copy
import sys
from typing import Optional

import torch

from ..core import dispatch
from ..core.tensor import Tensor, as_tensor
from ..nn.layer.layers import Layer
from ..ops.registry import register_module


def _t(x):
    return x if isinstance(x, Tensor) else as_tensor(x)


def weight_quantize(x, algo: str = "abs_max", bits: int = 8):
    """-> (int8 weights, per-channel (last dim) fp scales) (reference op
    weight_quantize)."""
    if algo not in ("abs_max", "weight_only_int8"):
        raise NotImplementedError(f"algo {algo!r}")
    qmax = 2 ** (bits - 1) - 1

    def f(w):
        scale = w.abs().amax(dim=0, keepdim=True) / qmax
        scale = scale.clamp_min(1e-8)
        q = torch.clamp(torch.round(w / scale), -qmax - 1, qmax)
        return q.to(torch.int8), scale[0]
    out = dispatch.call("weight_quantize", f, [_t(x)])
    return out[0], out[1]


def weight_dequantize(q, scale):
    """Dequantize int8 weights back to float with per-channel scales
    (reference weight_dequantize)."""
    def f(qa, s):
        return qa.to(s.dtype) * s[None, :]
    return dispatch.call("weight_dequantize", f, [_t(q), _t(scale)])


def fake_quant(x, scale=None, bits: int = 8):
    """QAT fake-quant with a straight-through estimator (reference
    fake_quantize_dequantize ops): forward rounds, backward passes
    through."""
    qmax = 2 ** (bits - 1) - 1

    def f(a):
        s = (a.abs().amax() / qmax) if scale is None else \
            torch.as_tensor(scale, dtype=a.dtype, device=a.device)
        s = s.clamp_min(1e-8)
        q = torch.clamp(torch.round(a / s), -qmax - 1, qmax) * s
        # STE: q = a + stop_grad(q - a) -> dq/da = 1
        return a + (q - a).detach()
    return dispatch.call("fake_quantize_dequantize", f, [_t(x)])


class QuantConfig:
    """reference quantization/config.py QuantConfig."""

    def __init__(self, activation=None, weight=None):
        self.activation = activation
        self.weight = weight
        self._layer_types = []

    def add_type_config(self, layer_type, activation=None, weight=None):
        self._layer_types.append((layer_type, activation, weight))
        return self


class QuantedLinear(Layer):
    """Linear running on int8 weights + fp scales (weight-only PTQ)."""

    def __init__(self, linear):
        super().__init__()
        q, scale = weight_quantize(linear.weight)
        # detached inference constants: no autograd lineage back to the
        # fp weight, no graph recorded on serving forwards
        self.register_buffer("qweight", Tensor(q._data.detach()))
        self.register_buffer("scales", Tensor(scale._data.detach()))
        self.bias = getattr(linear, "bias", None)

    def forward(self, x):
        def f(a, q, s, *b):
            w = q.to(a.dtype) * s[None, :]
            out = a @ w
            if b:
                out = out + b[0]
            return out
        args = [x if isinstance(x, Tensor) else as_tensor(x),
                self.qweight, self.scales]
        if self.bias is not None:
            args.append(self.bias)
        return dispatch.call("quant_linear", f, args)


class PTQ:
    """Post-training weight-only quantization (reference ptq.py):
    swap eligible Linear layers for QuantedLinear."""

    def __init__(self, config: Optional[QuantConfig] = None):
        self.config = config or QuantConfig()

    def quantize(self, model: Layer, inplace: bool = False) -> Layer:
        from ..nn import Linear
        target = model if inplace else copy.deepcopy(model)
        if isinstance(target, Linear):      # bare top-level Linear
            return QuantedLinear(target)
        for name, layer in list(target.named_sublayers()):
            if isinstance(layer, Linear):
                owner = target._locate_owner(name)
                attr = name.rsplit(".", 1)[-1]
                if owner is not None:
                    owner.add_sublayer(attr, QuantedLinear(layer))
        return target


class QAT:
    """Quantization-aware training (reference qat.py): Linear
    forwards compute with fake-quantized weights; the STE passes gradients
    through to the fp master weights the optimizer holds."""

    def __init__(self, config: Optional[QuantConfig] = None):
        self.config = config or QuantConfig()

    def quantize(self, model: Layer, inplace: bool = True) -> Layer:
        from ..nn import Linear
        from ..nn import functional as F
        target = model if inplace else copy.deepcopy(model)
        layers = [target] if isinstance(target, Linear) else []
        layers += [l for _, l in target.named_sublayers()]
        for layer in layers:
            if isinstance(layer, Linear) and not getattr(
                    layer, "_qat_wrapped", False):
                def qat_forward(x, _layer=layer):
                    return F.linear(x, fake_quant(_layer.weight),
                                    getattr(_layer, "bias", None))
                layer.forward = qat_forward
                layer._qat_wrapped = True
        return target


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=None, group_size=-1):
    """Matmul against int8-quantized weights with on-the-fly dequant
    (reference weight_only_linear op): the weight is dequantized into
    the activations' dtype, then multiplied.

    weight: (in, out) int8, weight_scale: (out,).
    """
    if weight_dtype != "int8":
        raise NotImplementedError(
            f"weight_only_linear: weight_dtype={weight_dtype!r} not "
            f"supported (int8 only, as in the JAX package)")
    if group_size != -1:
        raise NotImplementedError(
            "weight_only_linear: group-wise scales not supported "
            "(per-output-channel only)")
    tensors = [_t(x), _t(weight)]
    if weight_scale is not None:
        tensors.append(_t(weight_scale))
    if bias is not None:
        tensors.append(_t(bias))

    def f(a, w, *rest):
        i = 0
        s = None
        if weight_scale is not None:
            s = rest[i]
            i += 1
        b = rest[i] if bias is not None else None
        wd = w.to(a.dtype)
        if s is not None:
            wd = wd * s[None, :].to(a.dtype)
        out = a @ wd
        if b is not None:
            out = out + b
        return out

    mask = [True, False] + ([False] if weight_scale is not None else []) \
        + ([True] if bias is not None else [])
    return dispatch.call("weight_only_linear", f, tensors,
                         differentiable_mask=mask)


def _int8_product(aq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact integer product aq @ w of two int8 operands (the JAX
    package's int32-accumulated ``dot_general``), in float64: every sum
    of int8 products is an integer far inside float64's exact range."""
    return aq.to(torch.float64) @ w.to(torch.float64)


def llm_int8_linear(x, weight, bias=None, weight_scale=None,
                    threshold=6.0):
    """LLM.int8() mixed decomposition: columns of ``x`` with outliers
    (|x| > threshold) run in the activation dtype against dequantized
    weights; the rest runs int8 x int8 (reference llm_int8_linear op).
    weight: (in, out) int8; weight_scale: (out,).
    """
    xt = _t(x)
    use_ste = dispatch.grad_enabled() and not xt.stop_gradient
    tensors = [xt, _t(weight)]
    if weight_scale is not None:
        tensors.append(_t(weight_scale))
    if bias is not None:
        tensors.append(_t(bias))

    def f(a, w, *rest):
        i = 0
        s = None
        if weight_scale is not None:
            s = rest[i]
            i += 1
        b = rest[i] if bias is not None else None
        outlier = (a.abs() > threshold).any(
            dim=tuple(range(a.dim() - 1))) if a.dim() > 1 \
            else a.abs() > threshold                 # (in,) outlier columns
        keep = ~outlier
        # int8 path: quantize the non-outlier activation columns per row
        a_int = torch.where(keep, a, torch.zeros((), dtype=a.dtype,
                                                 device=a.device))
        row_scale = a_int.abs().amax(dim=-1, keepdim=True) / 127.0
        row_scale = row_scale.clamp_min(1e-8)
        aq = torch.clamp(torch.round(a_int / row_scale), -128, 127).to(
            torch.int8)
        int_exact = _int8_product(aq, w).to(a.dtype) * row_scale
        wd = w.to(a.dtype)
        if use_ste:
            # straight-through estimator: forward keeps the true int8
            # product; backward flows through the float surrogate so the
            # activation gradient of non-outlier columns is not dropped
            # by round/clip's zero derivative
            int_surrogate = a_int @ wd
            int_out = int_surrogate + (int_exact - int_surrogate).detach()
        else:
            int_out = int_exact
        # fp path for outlier columns against the dequantized weight
        a_fp = a - a_int
        out = int_out + a_fp @ wd
        if s is not None:
            out = out * s.to(a.dtype)
        if b is not None:
            out = out + b
        return out

    mask = [True, False] + ([False] if weight_scale is not None else []) \
        + ([True] if bias is not None else [])
    return dispatch.call("llm_int8_linear", f, tensors,
                         differentiable_mask=mask)


def apply_per_channel_scale(x, scales):
    """Divide activations by per-channel smoothing scales (SmoothQuant
    pre-scale; reference apply_per_channel_scale op)."""
    return dispatch.call("apply_per_channel_scale",
                         lambda a, s: a / s, [_t(x), _t(scales)],
                         differentiable_mask=[True, False])


__all__ = ["weight_quantize", "weight_dequantize", "fake_quant",
           "QuantConfig", "QuantedLinear", "PTQ", "QAT",
           "weight_only_linear", "llm_int8_linear",
           "apply_per_channel_scale"]


# the six ops in the registry, as the JAX package registers this module
register_module(sys.modules[__name__], "quantization")
