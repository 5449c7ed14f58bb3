"""Nucleus sampling (counterpart of ``nucleus_sample_ids`` in
``paddle_tpu/ops/search.py``).

The JAX function draws its uniforms from a key inside; this one takes
them as an argument, so a caller chooses where they come from (the
serving engine's counter-based draw, or JAX's own draw in a test) and
the same uniforms give the same ids in both packages. The JAX package's
``top_p_sampling`` (threshold, global or seeded key) is not ported.
"""
from __future__ import annotations

import torch

__all__ = ["nucleus_sample_ids"]


def nucleus_sample_ids(probs: torch.Tensor, p: torch.Tensor,
                       u: torch.Tensor) -> torch.Tensor:
    """Nucleus (top-p) draw from probability rows.

    probs: (B, V); p: (B,) nucleus mass per row; u: (B, V) uniforms in
    [1e-20, 1), read in sorted order (u[b, j] serves row b's j-th most
    probable token, as the JAX draw over the sorted shape does).

    Sort descending (ties keep their index order, as ``jnp.argsort`` of
    ``-probs`` does), keep tokens while the exclusive cumulative mass is
    below p (the top token always), renormalise, and take the Gumbel-max
    draw inside the nucleus. Returns (B, 1) int64 ids.
    """
    sp, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    csum = torch.cumsum(sp, dim=-1)
    keep = (csum - sp) < p[:, None]
    keep[:, 0] = True
    masked = torch.where(keep, sp, torch.zeros_like(sp))
    masked = masked / masked.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    gumbel = -torch.log(-torch.log(u))
    score = torch.where(keep, torch.log(masked + 1e-20) + gumbel,
                        torch.full_like(masked, -float("inf")))
    choice = torch.argmax(score, dim=-1, keepdim=True)
    return torch.gather(order, -1, choice)
