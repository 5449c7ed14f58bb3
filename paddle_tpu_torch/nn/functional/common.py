"""Dropout (counterpart of ``dropout`` in
``paddle_tpu/nn/functional/common.py``).

The JAX package draws its mask from a global key. The port draws it from
the ``torch.Generator`` the caller hands in, and never from torch's
global RNG: a dropout that has to draw and has no generator raises.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch


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


__all__ = ["dropout"]
