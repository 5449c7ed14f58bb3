"""Functionals ported so far: linear and matmul, attention (flash and
paged), dropout, cross entropy and the fused chunked LM-head loss, norms,
activations and the four fused ops of the fusion pass."""
from .activation import gelu, relu, silu, softmax, swiglu
from .common import dropout, linear, matmul
from .flash_attention import flash_attention, scaled_dot_product_attention
from .fused import (ACTIVATIONS, FUSED_OPS, fused_bias_act, fused_norm_linear,
                    fused_residual_norm, fused_rope_proj)
from .loss import cross_entropy, fused_linear_cross_entropy
from .norm import layer_norm, rms_norm
from .paged_attention import block_multihead_attention

__all__ = ["linear", "matmul", "flash_attention",
           "scaled_dot_product_attention", "block_multihead_attention",
           "dropout", "cross_entropy", "fused_linear_cross_entropy",
           "layer_norm", "rms_norm", "gelu", "silu", "relu", "softmax",
           "swiglu", "fused_bias_act", "fused_residual_norm",
           "fused_norm_linear", "fused_rope_proj", "FUSED_OPS", "ACTIVATIONS"]
