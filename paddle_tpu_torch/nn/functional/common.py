"""Linear, matmul and dropout (counterparts of ``linear`` and ``dropout``
in ``paddle_tpu/nn/functional/common.py`` and of ``matmul`` in
``paddle_tpu/ops/linalg.py``).

``linear`` takes its weight in torch's ``nn.Linear`` layout, (out, in),
where the JAX package's is (in, out). Both products cast their inputs
for amp (``amp_cast``, white list).

The JAX package draws its dropout mask from a global key. The port draws
it from the ``torch.Generator`` the caller hands in, and never from
torch's global RNG: a dropout that has to draw and has no generator
raises.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch.nn import functional as TF

from ...amp.state import amp_cast


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, name=None) -> torch.Tensor:
    """x W^T + b, with W (out, in); the weight and bias in x's dtype, as
    the JAX package casts them."""
    x, weight, bias = amp_cast("linear", x, weight, bias)
    return TF.linear(x, weight.to(x.dtype),
                     None if bias is None else bias.to(x.dtype))


def matmul(x: torch.Tensor, y: torch.Tensor, transpose_x: bool = False,
           transpose_y: bool = False, name=None) -> torch.Tensor:
    """Batched product with broadcasting; ``transpose_x``/``transpose_y``
    swap the last two dims of an operand of two dims or more. Mixed
    dtypes promote, as ``jnp.matmul`` promotes them."""
    x, y = amp_cast("matmul", x, y)
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    dt = torch.promote_types(x.dtype, y.dtype)
    return torch.matmul(x.to(dt), y.to(dt))


def dropout(x: torch.Tensor, p: float = 0.5,
            axis: Optional[Union[int, Sequence[int]]] = None,
            training: bool = True, mode: str = "upscale_in_train",
            name=None, generator: Optional[torch.Generator] = None
            ) -> torch.Tensor:
    """Zero elements with probability ``p`` while training, rescaling the
    survivors by 1/(1-p) (``mode="upscale_in_train"``) or scaling by
    (1-p) at inference (``"downscale_in_infer"``). ``axis`` shares one
    draw along the other dims. The mask comes from ``generator``, which
    must lie on ``x``'s device."""
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


__all__ = ["linear", "matmul", "dropout"]
