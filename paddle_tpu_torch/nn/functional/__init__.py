"""Functionals ported so far: attention (flash and paged), dropout and
cross entropy."""
from .common import dropout
from .flash_attention import flash_attention, scaled_dot_product_attention
from .loss import cross_entropy
from .paged_attention import block_multihead_attention

__all__ = ["flash_attention", "scaled_dot_product_attention",
           "block_multihead_attention", "dropout", "cross_entropy"]
