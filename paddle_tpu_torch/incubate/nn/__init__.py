"""incubate.nn (counterpart of ``paddle_tpu/incubate/nn/``): the MoE
layers and the fused transformer layers at Paddle's import path. The
JAX package's ``faster_tokenizer`` (``FasterTokenizer``,
``BertTokenizer``, ``load_vocab``) is still to port (ROADMAP)."""
from ...distributed.fleet.moe import MoELayer, TopKGate
from . import functional  # noqa: F401
from .layers import (FusedBiasDropoutResidualLayerNorm, FusedDropoutAdd,
                     FusedFeedForward, FusedLinear, FusedMultiHeadAttention,
                     FusedTransformerEncoderLayer)

__all__ = ["MoELayer", "TopKGate", "functional", "FusedLinear",
           "FusedDropoutAdd", "FusedBiasDropoutResidualLayerNorm",
           "FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer"]
