"""The models' block checkpointing (counterpart of
``paddle_tpu/models/_remat.py``).

Eager: each block goes through ``fleet.recompute``, so only the block's
input is kept for the backward and its interior is recomputed there.
Under ``to_static``, each such block is a region of its own: the fx
tracer's (``compile/fusion/fx.py``) for ``torch.nn.Module``s, the op
recorder's (``jit/program.py``) for Paddle-API ``Layer``s. The block's
program is recorded and fused apart, and the outer program calls it
under the same checkpoint.
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor, active_capture


def remat_block(blk, *args):
    """``blk(*args)`` with activation checkpointing while grad is enabled
    (plainly otherwise)."""
    rec = active_capture()
    if rec is not None and rec.root.broken is None \
            and any(isinstance(a, Tensor) for a in args):
        return rec.region(blk, args)
    if not torch.is_grad_enabled():
        return blk(*args)
    from ..distributed.fleet.recompute import recompute
    return recompute(blk, *args)
