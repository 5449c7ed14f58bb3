"""The models' block checkpointing (counterpart of
``paddle_tpu/models/_remat.py``).

Eager: each block goes through ``fleet.recompute``, so only the block's
input is kept for the backward and its interior is recomputed there.
Under ``to_static``, the tracer keeps each such block as a region of its
own (``compile/fusion/fx.py``): the block's graph is traced and fused
apart, and the outer graph calls it under the same checkpoint.
"""
from __future__ import annotations

import torch


def remat_block(blk, *args):
    """``blk(*args)`` with activation checkpointing while grad is enabled
    (plainly otherwise)."""
    if not torch.is_grad_enabled():
        return blk(*args)
    from ..distributed.fleet.recompute import recompute
    return recompute(blk, *args)
