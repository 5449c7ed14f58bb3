"""paddle.nn.quant (counterpart of ``paddle_tpu/nn/quant/``): the
quantization layers and functionals of ``paddle_tpu_torch.quantization``
at Paddle's nn import path."""
from ...quantization import (PTQ, QAT, QuantConfig, QuantedLinear,
                             fake_quant, llm_int8_linear, weight_dequantize,
                             weight_only_linear, weight_quantize)

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear",
           "llm_int8_linear", "fake_quant", "QuantConfig", "QuantedLinear",
           "PTQ", "QAT"]
