"""Functionals ported so far: linear and matmul, embedding, attention
(flash and paged), dropout, cross entropy and the fused chunked LM-head
loss, norms, activations, the four fused ops of the fusion pass, and
the convolutions and pools.

The Paddle-API entries (``linear``, ``dropout``, ``embedding``, ``gelu``,
``relu``, ``silu``, ``tanh``, ``sigmoid``, ``softmax``, ``layer_norm``,
``rms_norm``, ``batch_norm``, ``cross_entropy``,
``fused_linear_cross_entropy``, ``scaled_dot_product_attention``,
``flash_attention``, ``matmul``, and the fused ops ``fused_bias_act``,
``fused_residual_norm``, ``fused_norm_linear``, ``fused_rope_proj``)
take Paddle ``Tensor``s through the op dispatcher, and the same
functions take ``torch.Tensor``s as the torch-level functionals of the
port's models and fusion pass; each module's docstring says where a
layout differs (the weights of ``linear``, ``fused_norm_linear`` and
``fused_rope_proj``)."""
from .activation import gelu, relu, sigmoid, silu, softmax, swiglu, tanh
from .common import dropout, embedding, linear, matmul
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose,
                   conv3d, conv3d_transpose)
from .flash_attention import flash_attention, scaled_dot_product_attention
from .fused import (ACTIVATIONS, FUSED_OPS, fused_bias_act, fused_norm_linear,
                    fused_residual_norm, fused_rope_proj)
from .loss import cross_entropy, fused_linear_cross_entropy
from .norm import batch_norm, layer_norm, rms_norm
from .paged_attention import block_multihead_attention
from .pooling import *  # noqa: F401,F403
from .pooling import __all__ as _pools

__all__ = ["linear", "matmul", "flash_attention",
           "scaled_dot_product_attention", "block_multihead_attention",
           "dropout", "embedding", "cross_entropy",
           "fused_linear_cross_entropy", "layer_norm", "rms_norm",
           "batch_norm", "gelu", "silu", "relu", "tanh", "sigmoid", "softmax",
           "swiglu", "fused_bias_act", "fused_residual_norm",
           "fused_norm_linear", "fused_rope_proj", "FUSED_OPS", "ACTIVATIONS",
           "conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"] + list(_pools)
