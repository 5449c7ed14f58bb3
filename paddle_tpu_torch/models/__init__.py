"""Models of the PyTorch port, under the JAX package's names."""
from .convert import load_jax_state
from .gpt import (GPTAttention, GPTBlock, GPTConfig, GPTForCausalLM, GPTMLP,
                  GPTModel, gpt2_medium, gpt2_small)

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTBlock", "GPTModel",
           "GPTForCausalLM", "gpt2_small", "gpt2_medium", "load_jax_state"]
