"""CUDA C++ kernels for Hopper (sources in ``paddle_tpu_torch/csrc``),
built with nvcc and bound with ctypes by ``_build``."""
from .flash_attention import flash_attention_fwd, flash_attention_fwd_plain

__all__ = ["flash_attention_fwd", "flash_attention_fwd_plain"]
