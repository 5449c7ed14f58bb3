"""Normalization functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``): statistics in fp32, the output in
the input's dtype, as the JAX lowerings compute them."""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch


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
    ``normalized_shape`` dims."""
    ndim = 1 if isinstance(normalized_shape, int) else len(normalized_shape)
    dims = tuple(range(x.dim() - ndim, x.dim()))
    a32 = x.float()
    mean = a32.mean(dim=dims, keepdim=True)
    var = a32.var(dim=dims, unbiased=False, keepdim=True)
    y = (a32 - mean) / torch.sqrt(var + epsilon)
    return _affine(y, weight, bias).to(x.dtype)


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             bias: Optional[torch.Tensor] = None, epsilon: float = 1e-6,
             begin_norm_axis: int = -1, name=None) -> torch.Tensor:
    """x / sqrt(mean(x^2) + epsilon) * weight + bias over the dims from
    ``begin_norm_axis`` on."""
    axis = begin_norm_axis % x.dim()
    dims = tuple(range(axis, x.dim()))
    a32 = x.float()
    ms = (a32 * a32).mean(dim=dims, keepdim=True)
    y = a32 * (1.0 / torch.sqrt(ms + epsilon))
    return _affine(y, weight, bias).to(x.dtype)


__all__ = ["layer_norm", "rms_norm"]
