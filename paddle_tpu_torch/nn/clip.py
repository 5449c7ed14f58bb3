"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``).

The objects are handed to an optimizer (``grad_clip=``), which calls them
on its ``(param, grad)`` list before the update. Norms are taken in fp32
and each clipped gradient is cast back to its own dtype, as in the JAX
package. A parameter with ``need_clip = False`` is passed through.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

ParamsGrads = List[Tuple[torch.Tensor, Optional[torch.Tensor]]]


def _clipped(p) -> bool:
    return getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads: ParamsGrads) -> ParamsGrads:
        return self._dygraph_clip(params_grads)

    def _dygraph_clip(self, params_grads: ParamsGrads) -> ParamsGrads:
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Clamp every gradient element to [min, max] (min defaults to -max)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _dygraph_clip(self, params_grads):
        return [(p, g.clamp(self.min, self.max)
                 if g is not None and _clipped(p) else g)
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Scale each gradient to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _one(self, g):
        g32 = g.float()
        norm = torch.sqrt((g32 * g32).sum())
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        return (g32 * scale).to(g.dtype)

    def _dygraph_clip(self, params_grads):
        return [(p, self._one(g) if g is not None and _clipped(p) else g)
                for p, g in params_grads]


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale all gradients by clip_norm / max(global_norm, clip_norm),
    where global_norm is the L2 norm of all of them together."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name
        self.auto_skip_clip = auto_skip_clip

    @staticmethod
    def _global_norm(grads) -> torch.Tensor:
        sq = None
        for g in grads:
            g32 = g.float()
            s = (g32 * g32).sum()
            sq = s if sq is None else sq + s
        return torch.sqrt(sq)

    def _dygraph_clip(self, params_grads):
        grads = [g for p, g in params_grads if g is not None and _clipped(p)]
        if not grads:
            return params_grads
        norm = self._global_norm(grads)
        scale = self.clip_norm / torch.clamp(norm, min=self.clip_norm)
        return [(p, (g.float() * scale).to(g.dtype)
                 if g is not None and _clipped(p) else g)
                for p, g in params_grads]


__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]
