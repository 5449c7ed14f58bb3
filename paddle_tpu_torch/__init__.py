"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

A package of its own beside ``paddle_tpu`` (the JAX reference, which it
never imports). It works on ``torch.Tensor`` directly. Every TPU kernel
on a ported path is a kernel written by hand for Hopper under
``csrc/``, built at first use; entry points run on the card unless the
caller passes ``device="cpu"``.

Ported so far: GPT-2 inference through the flash-attention forward
kernel, greedy serving over paged KV caches (``PagedEngine``), and GPT-2
training (cross entropy, AdamW with gradient clipping and LR schedules)
through the forward and backward flash-attention kernels.
"""
from . import core, inference, models, nn, ops, optimizer
from .core import resolve_device
from .inference import GPTPagedEngine, PagedEngine
from .models import GPTConfig, GPTForCausalLM, gpt2_medium, gpt2_small

__all__ = ["core", "inference", "models", "nn", "ops", "optimizer",
           "resolve_device",
           "GPTConfig", "GPTForCausalLM", "gpt2_small", "gpt2_medium",
           "PagedEngine", "GPTPagedEngine"]
