"""Fused ops, the rewrite targets of the graph-fusion pass (counterpart of
``paddle_tpu/nn/functional/fused.py``).

Each op has two implementations of one function:

* the kernel (``ops/cuda/fused_ops.py``, K4-K7): on CUDA tensors the
  hand-written Hopper kernel, on CPU tensors its plain version;
* the composite: the unfused chain in plain PyTorch, the numerics reference
  the backward recomputes through.

Gradients: the forward runs the kernel and saves its inputs; the backward
rebuilds the composite under ``torch.enable_grad()`` and differentiates it
(the JAX package's ``_with_composite_vjp``). The backward launches none of
K4-K7. A bias of another dtype than x takes the composite, whose output
type follows PyTorch's promotion, so it is a different function, not a
fallback. A residual of another floating dtype than x goes with x to
their promoted dtype, where K4 computes the composite's function (the
sum is exact in it); the JAX package takes the composite there. On
torch.Tensors the weights are in torch's ``nn.Linear`` layout,
(out_features, in_features), as ``torch.nn.functional.linear`` takes
them.

On Paddle ``Tensor``s each op is one op through ``core.dispatch.call``
under the JAX package's name and signature (registered in
``ops.registry``, category ``fusion``), with Paddle's (in, out) weight:
the lowering hands the kernel the transposed weight, copied to the
(out, in) rows K6 and K7 read. ``to_static``'s op-stream fusion rewrites
Paddle-API programs onto these.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from ...amp.state import amp_cast
from ...core import dispatch
from ...core.tensor import Tensor, as_tensor
from ...ops.cuda import fused_ops as FK
from ...ops.registry import register

__all__ = ["fused_bias_act", "fused_residual_norm", "fused_norm_linear",
           "fused_rope_proj", "FUSED_OPS", "ACTIVATIONS", "FusedCall"]

#: the closed fused-op vocabulary
FUSED_OPS = ("fused_bias_act", "fused_residual_norm", "fused_norm_linear",
             "fused_rope_proj")

ACTIVATIONS = ("gelu", "gelu_tanh", "silu", "relu")


def _norm32(a32, w32, b32, norm_type: str, eps: float):
    """fp32 row norm as the unfused ``layer_norm`` / ``rms_norm`` compute
    it (the composite's reference numerics)."""
    if norm_type == "rms_norm":
        y = a32 / torch.sqrt((a32 * a32).mean(dim=-1, keepdim=True) + eps)
    else:
        mean = a32.mean(dim=-1, keepdim=True)
        var = a32.var(dim=-1, unbiased=False, keepdim=True)
        y = (a32 - mean) / torch.sqrt(var + eps)
    if w32 is not None:
        y = y * w32
    if b32 is not None:
        y = y + b32
    return y


def _cast(t: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.float()


class _FusedFunction(torch.autograd.Function):
    """Kernel forward, composite-recompute backward."""

    @staticmethod
    def forward(ctx, kernel, composite, *inputs):
        ctx.composite = composite
        ctx.save_for_backward(*inputs)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, needs)]
            outs = ctx.composite(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        wanted = [leaf for leaf, need in zip(leaves, needs) if need]
        if not pairs or not wanted:
            return (None,) * (2 + len(needs))
        got = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                       [g for _, g in pairs],
                                       allow_unused=True))
        return (None, None) + tuple(next(got) if need else None
                                    for need in needs)


def _tensors(*xs):
    """The Paddle Tensors of ``xs`` (other data made Tensors), Nones
    dropped."""
    return [x if isinstance(x, Tensor) else as_tensor(x)
            for x in xs if x is not None]


# ------------------------------------------------------------ bias + act
def _bias_act_composite(x, b, activation):
    return FK.act_apply(x + b, activation)


def _bias_act_kernel(x, b, activation):
    d = x.shape[-1]
    return FK.fused_bias_act(x.reshape(-1, d), b,
                             act=activation).reshape(x.shape)


@register("fused_bias_act", "fusion")
def fused_bias_act(x, bias, activation: str = "gelu", name=None):
    """act(x + bias) as one op (K5); ``activation``: gelu | gelu_tanh |
    silu | relu. ``bias`` is (D,) for x (..., D)."""
    if isinstance(x, Tensor):
        return dispatch.call("fused_bias_act", lambda a, b: fused_bias_act(
            a, b, activation), _tensors(x, bias))
    if bias.dtype != x.dtype:
        return _bias_act_composite(x, bias, activation)
    return _FusedFunction.apply(
        functools.partial(_bias_act_kernel, activation=activation),
        functools.partial(_bias_act_composite, activation=activation),
        x, bias)


# -------------------------------------------------------- residual + norm
def _residual_norm_composite(x, res, w, b, norm_type, epsilon):
    s = x + res
    y = _norm32(s.float(), _f32(w), _f32(b), norm_type, epsilon)
    return y.to(s.dtype), s


def _residual_norm_kernel(x, res, w, b, norm_type, epsilon):
    if res.shape != x.shape:
        raise ValueError(f"fused_residual_norm: residual {tuple(res.shape)} "
                         f"must have x's shape {tuple(x.shape)}")
    d = x.shape[-1]
    y, s = FK.fused_residual_norm(x.reshape(-1, d), res.reshape(-1, d),
                                  _cast(w, x.dtype), _cast(b, x.dtype),
                                  kind=norm_type, eps=epsilon)
    return y.reshape(x.shape), s.reshape(x.shape)


@register("fused_residual_norm", "fusion")
def fused_residual_norm(x, residual, weight=None, bias=None,
                        norm_type: str = "layer_norm", epsilon: float = 1e-5,
                        name=None):
    """(norm(x + residual), x + residual) as one op (K4). The sum is a real
    output, so the residual stream flows on without a recompute. The
    kernel normalizes the fp32 sum; the unfused chain normalizes the sum
    rounded to x's type, which differs by about one rounding in bf16.
    Floating x and residual of two dtypes both go to the promoted one."""
    if isinstance(x, Tensor):
        has_w, has_b = weight is not None, bias is not None

        def f(a, r, *wb):
            return fused_residual_norm(
                a, r, wb[0] if has_w else None, wb[has_w] if has_b else None,
                norm_type, epsilon)
        return dispatch.call("fused_residual_norm", f,
                             _tensors(x, residual, weight, bias))
    if residual.dtype != x.dtype:
        if not (x.is_floating_point() and residual.is_floating_point()):
            return _residual_norm_composite(x, residual, weight, bias,
                                            norm_type, epsilon)
        dt = torch.promote_types(x.dtype, residual.dtype)
        x, residual = x.to(dt), residual.to(dt)
    attrs = dict(norm_type=norm_type, epsilon=epsilon)
    return _FusedFunction.apply(
        functools.partial(_residual_norm_kernel, **attrs),
        functools.partial(_residual_norm_composite, **attrs),
        x, residual, weight, bias)


# ---------------------------------------------------- norm + linear + act
def _norm_linear_composite(x, w, b, nw, nb, norm_type, epsilon, activation):
    xn = x
    if norm_type:
        xn = _norm32(x.float(), _f32(nw), _f32(nb), norm_type,
                     epsilon).to(x.dtype)
    y = torch.matmul(xn, w.to(xn.dtype).t())
    if b is not None:
        y = y + b.to(y.dtype)
    return FK.act_apply(y, activation)


def _norm_linear_kernel(x, w, b, nw, nb, norm_type, epsilon, activation):
    k, n = x.shape[-1], w.shape[0]
    dt = x.dtype
    y = FK.fused_matmul(x.reshape(-1, k), w.to(dt).contiguous(), _cast(b, dt),
                        _cast(nw, dt), _cast(nb, dt), norm_kind=norm_type,
                        act=activation, eps=epsilon)
    return y.reshape(*x.shape[:-1], n)


@register("fused_norm_linear", "fusion")
def fused_norm_linear(x, weight, bias=None, norm_weight=None, norm_bias=None,
                      activation: str = "", norm_type: str = "layer_norm",
                      epsilon: float = 1e-5, name=None):
    """act(norm(x) W^T + b) as one op (K6). ``weight`` is (N, K), torch's
    ``nn.Linear`` layout, on torch.Tensors and (K, N), Paddle's, on Paddle
    Tensors; ``norm_type=''`` skips the norm and ``activation=''`` the
    activation. The normalized rows are rounded to x's type before the
    product."""
    if isinstance(x, Tensor):
        flags = (bias is not None, norm_weight is not None,
                 norm_bias is not None)

        def f(a, w, *rest):
            it = iter(rest)
            b, nw, nb = (next(it) if on else None for on in flags)
            return fused_norm_linear(a, w.t(), b, nw, nb, activation,
                                     norm_type, epsilon)
        return dispatch.call("fused_norm_linear", f, _tensors(
            x, weight, bias, norm_weight, norm_bias))
    x, weight, bias, norm_weight, norm_bias = amp_cast(
        "fused_norm_linear", x, weight, bias, norm_weight, norm_bias)
    attrs = dict(norm_type=norm_type, epsilon=epsilon, activation=activation)
    return _FusedFunction.apply(
        functools.partial(_norm_linear_kernel, **attrs),
        functools.partial(_norm_linear_composite, **attrs),
        x, weight, bias, norm_weight, norm_bias)


# ----------------------------------------------------------- rope + proj
def _rope_proj_composite(x, w, b, num_heads, theta, pos_offset):
    from ...models.llama import rope_rotate
    y = torch.matmul(x, w.to(x.dtype).t())
    if b is not None:
        y = y + b.to(y.dtype)
    bt, s = x.shape[0], x.shape[1]
    return rope_rotate(y.reshape(bt, s, num_heads, -1), theta, pos_offset)


def _rope_proj_kernel(x, w, b, num_heads, theta, pos_offset):
    bt, s, k = x.shape
    n = w.shape[0]
    y = FK.fused_matmul_rope(x.reshape(bt * s, k), w.to(x.dtype).contiguous(),
                             _cast(b, x.dtype), seq=s,
                             head_dim=n // num_heads, theta=theta,
                             pos_offset=pos_offset)
    return y.view(bt, s, num_heads, n // num_heads)


@register("fused_rope_proj", "fusion")
def fused_rope_proj(x, weight, bias=None, num_heads: int = 1,
                    theta: float = 10000.0, pos_offset: int = 0, name=None):
    """rope(reshape(x W^T + b, heads)) as one op (K7): x (B, S, K),
    ``weight`` (H*D, K) in torch's ``nn.Linear`` layout (on Paddle
    Tensors (K, H*D), Paddle's) -> (B, S, H, D), rotary-rotated.
    ``pos_offset`` must be a Python int (a per-slot offset stays on the
    unfused path)."""
    if isinstance(x, Tensor):
        return dispatch.call("fused_rope_proj", lambda a, w, *b: (
            fused_rope_proj(a, w.t(), *b, num_heads=num_heads, theta=theta,
                            pos_offset=pos_offset)),
            _tensors(x, weight, bias))
    if x.dim() != 3:
        raise ValueError(f"fused_rope_proj: x must be (B, S, K), got "
                         f"{tuple(x.shape)}")
    if isinstance(pos_offset, bool) or not isinstance(pos_offset, int):
        raise TypeError("fused_rope_proj: pos_offset must be a Python int")
    x, weight, bias = amp_cast("fused_rope_proj", x, weight, bias)
    attrs = dict(num_heads=int(num_heads), theta=float(theta),
                 pos_offset=pos_offset)
    return _FusedFunction.apply(
        functools.partial(_rope_proj_kernel, **attrs),
        functools.partial(_rope_proj_composite, **attrs),
        x, weight, bias)


# --------------------------------------------- lowerings for the fusion pass
class FusedCall:
    """A fused op bound to its attributes, as the fusion pass emits it:
    ``fn`` is the public functional, ``inputs`` names the tensors the
    pass hands over in order (the first goes positionally)."""

    def __init__(self, fn, inputs: Sequence[str], attrs: Dict):
        self.fn, self.inputs, self.attrs = fn, tuple(inputs), dict(attrs)

    def bind(self, values: Sequence) -> Tuple[tuple, dict]:
        kwargs = dict(zip(self.inputs[1:], values[1:]))
        kwargs.update(self.attrs)
        return (values[0],), kwargs

    def __call__(self, *values):
        args, kwargs = self.bind(values)
        return self.fn(*args, **kwargs)


def _names(*pairs) -> Tuple[str, ...]:
    return tuple(name for name, present in pairs if present)


def bias_act_lowering(activation: str) -> FusedCall:
    return FusedCall(fused_bias_act, ("x", "bias"),
                     {"activation": activation})


def residual_norm_lowering(norm_type: str, epsilon: float, has_w: bool,
                           has_b: bool) -> FusedCall:
    return FusedCall(fused_residual_norm,
                     _names(("x", 1), ("residual", 1), ("weight", has_w),
                            ("bias", has_b)),
                     {"norm_type": norm_type, "epsilon": epsilon})


def norm_linear_lowering(norm_type: str, epsilon: float, activation: str,
                         has_bias: bool, has_nw: bool,
                         has_nb: bool) -> FusedCall:
    """Inputs in order: (x, weight[, bias][, norm_weight][, norm_bias])."""
    return FusedCall(fused_norm_linear,
                     _names(("x", 1), ("weight", 1), ("bias", has_bias),
                            ("norm_weight", has_nw), ("norm_bias", has_nb)),
                     {"norm_type": norm_type, "epsilon": epsilon,
                      "activation": activation})


def rope_proj_lowering(num_heads: int, theta: float, pos_offset: int,
                       has_bias: bool) -> FusedCall:
    return FusedCall(fused_rope_proj,
                     _names(("x", 1), ("weight", 1), ("bias", has_bias)),
                     {"num_heads": num_heads, "theta": theta,
                      "pos_offset": pos_offset})
