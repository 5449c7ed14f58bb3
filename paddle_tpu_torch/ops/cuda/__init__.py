"""CUDA C++ kernels for Hopper (sources in ``paddle_tpu_torch/csrc``),
built with nvcc and bound with ctypes by ``_build``."""
from .flash_attention import (FlashAttentionFunction, flash_attention_bwd_dkv,
                              flash_attention_bwd_dq,
                              flash_attention_bwd_plain, flash_attention_fwd,
                              flash_attention_fwd_plain)

__all__ = ["FlashAttentionFunction", "flash_attention_fwd",
           "flash_attention_fwd_plain", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "flash_attention_bwd_plain"]
