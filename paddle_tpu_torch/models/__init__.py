"""Models of the PyTorch port, under the JAX package's names. GPT-2 and
LLaMA are ``torch.nn.Module``s on ``torch.Tensor``; BERT is written in the
Paddle API (``nn.Layer`` over Paddle Tensors), as in the JAX package."""
from .bert import (BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel, bert_base,
                   bert_large)
from .convert import load_jax_layer_state, load_jax_state
from .gpt import (GPTAttention, GPTBlock, GPTConfig, GPTForCausalLM, GPTMLP,
                  GPTModel, gpt2_medium, gpt2_small)
from .llama import (LlamaAttention, LlamaBlock, LlamaConfig, LlamaForCausalLM,
                    LlamaMLP, LlamaModel, llama2_13b, llama2_70b, llama_7b,
                    llama_tiny, rope_rotate, rotary_embedding)

__all__ = ["BertConfig", "BertModel", "BertForPretraining",
           "BertForSequenceClassification", "bert_base", "bert_large",
           "load_jax_layer_state", "GPTConfig", "GPTAttention", "GPTMLP", "GPTBlock", "GPTModel",
           "GPTForCausalLM", "gpt2_small", "gpt2_medium", "load_jax_state",
           "LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaBlock",
           "LlamaModel", "LlamaForCausalLM", "llama_7b", "llama_tiny",
           "llama2_13b", "llama2_70b", "rope_rotate", "rotary_embedding"]
