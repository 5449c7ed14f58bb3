"""Models of the PyTorch port, under the JAX package's names."""
from .convert import load_jax_state
from .gpt import (GPTAttention, GPTBlock, GPTConfig, GPTForCausalLM, GPTMLP,
                  GPTModel, gpt2_medium, gpt2_small)
from .llama import (LlamaAttention, LlamaBlock, LlamaConfig, LlamaForCausalLM,
                    LlamaMLP, LlamaModel, llama2_13b, llama2_70b, llama_7b,
                    llama_tiny, rope_rotate, rotary_embedding)

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTBlock", "GPTModel",
           "GPTForCausalLM", "gpt2_small", "gpt2_medium", "load_jax_state",
           "LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaBlock",
           "LlamaModel", "LlamaForCausalLM", "llama_7b", "llama_tiny",
           "llama2_13b", "llama2_70b", "rope_rotate", "rotary_embedding"]
