"""incubate.nn.functional (counterpart of
``paddle_tpu/incubate/nn/functional/``): the serving attention at
Paddle's incubate import path."""
from ....nn.functional.paged_attention import block_multihead_attention

__all__ = ["block_multihead_attention"]
