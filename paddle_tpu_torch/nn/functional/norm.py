"""Normalization functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``): statistics in fp32, the output in
the input's dtype, as the JAX lowerings compute them. Both are on amp's
black list: under O1/O2 their inputs go to fp32 first, so they return
fp32."""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch.nn import functional as TF

from ...amp.state import amp_cast


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.float()


def _affine(y: torch.Tensor, weight: Optional[torch.Tensor],
            bias: Optional[torch.Tensor]) -> torch.Tensor:
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y


def layer_norm(x: torch.Tensor, normalized_shape: Union[int, Sequence[int]],
               weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, epsilon: float = 1e-5,
               name=None) -> torch.Tensor:
    """(x - mean) / sqrt(var + epsilon) * weight + bias over the trailing
    ``normalized_shape`` dims. Where the weight and bias share x's dtype,
    torch's own layer norm computes it (fp32 statistics and affine, one
    rounding); otherwise x and the parameters go to fp32 and the result
    back to x's dtype."""
    x, weight, bias = amp_cast("layer_norm", x, weight, bias)
    shape = ((normalized_shape,) if isinstance(normalized_shape, int)
             else tuple(normalized_shape))
    if all(t is None or t.dtype == x.dtype for t in (weight, bias)):
        return TF.layer_norm(x, shape, weight, bias, epsilon)
    return TF.layer_norm(x.float(), shape, _f32(weight), _f32(bias),
                         epsilon).to(x.dtype)


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             bias: Optional[torch.Tensor] = None, epsilon: float = 1e-6,
             begin_norm_axis: int = -1, name=None) -> torch.Tensor:
    """x / sqrt(mean(x^2) + epsilon) * weight + bias over the dims from
    ``begin_norm_axis`` on."""
    x, weight, bias = amp_cast("rms_norm", x, weight, bias)
    axis = begin_norm_axis % x.dim()
    dims = tuple(range(axis, x.dim()))
    a32 = x.float()
    ms = (a32 * a32).mean(dim=dims, keepdim=True)
    y = a32 * (1.0 / torch.sqrt(ms + epsilon))
    return _affine(y, weight, bias).to(x.dtype)


__all__ = ["layer_norm", "rms_norm"]
