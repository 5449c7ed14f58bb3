"""Functionals ported so far: attention (flash and paged), dropout, cross
entropy, norms, activations and the four fused ops of the fusion pass."""
from .activation import gelu, relu, silu, swiglu
from .common import dropout
from .flash_attention import flash_attention, scaled_dot_product_attention
from .fused import (ACTIVATIONS, FUSED_OPS, fused_bias_act, fused_norm_linear,
                    fused_residual_norm, fused_rope_proj)
from .loss import cross_entropy
from .norm import layer_norm, rms_norm
from .paged_attention import block_multihead_attention

__all__ = ["flash_attention", "scaled_dot_product_attention",
           "block_multihead_attention", "dropout", "cross_entropy",
           "layer_norm", "rms_norm", "gelu", "silu", "relu", "swiglu",
           "fused_bias_act", "fused_residual_norm", "fused_norm_linear",
           "fused_rope_proj", "FUSED_OPS", "ACTIVATIONS"]
