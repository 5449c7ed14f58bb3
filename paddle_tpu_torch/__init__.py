"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

A package of its own beside ``paddle_tpu`` (the JAX reference, which it
never imports). It works on ``torch.Tensor`` directly. Every TPU kernel
on a ported path is a kernel written by hand for Hopper under
``csrc/``, built at first use; entry points run on the card unless the
caller passes ``device="cpu"``.

Ported so far: GPT-2 inference through the flash-attention forward
kernel, serving of GPT-2 and LLaMA over paged KV caches (``PagedEngine``:
per-request sampling, int8 KV pages, the phase-split scheduler and n-gram
speculative decoding, ``serving``), and GPT-2
training (cross entropy, AdamW with gradient clipping and LR schedules)
through the forward and backward flash-attention kernels; LLaMA, and
``jit.to_static`` whose graph-fusion pass (``FLAGS_enable_fusion``)
rewrites training onto the fused kernels (residual + norm, bias +
activation, norm + matmul + activation, matmul + rope); amp (O1
``auto_cast``, O2 ``decorate``, ``GradScaler``), the fused chunked
LM-head loss, block recompute (``distributed.fleet.recompute``) and
bf16/int8 Adam moments.
"""
from . import (amp, compile, core, distributed, inference, jit, models, nn,
               ops, optimizer, serving)
from .core import get_flag, resolve_device, set_flags
from .inference import GPTPagedEngine, LlamaPagedEngine, PagedEngine
from .jit import to_static
from .models import (GPTConfig, GPTForCausalLM, LlamaConfig, LlamaForCausalLM,
                     gpt2_medium, gpt2_small)

__all__ = ["amp", "compile", "core", "distributed", "inference", "jit",
           "models", "nn", "ops", "optimizer", "serving", "resolve_device",
           "get_flag",
           "set_flags", "to_static", "GPTConfig", "GPTForCausalLM",
           "gpt2_small", "gpt2_medium", "LlamaConfig", "LlamaForCausalLM",
           "PagedEngine", "GPTPagedEngine", "LlamaPagedEngine"]
