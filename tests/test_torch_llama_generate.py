"""The port's LLaMA cached decoding against the JAX package's.

A tiny LLaMA (2 layers, hidden 64, vocab 97, plain attention), MHA and
GQA, gets numpy-seeded weights in the JAX model, and ``load_jax_state``
carries them into the port's. ``generate`` with and without the KV cache
must give the JAX ``generate``'s greedy tokens; one block's cached
attention step must give the JAX block's output and cache (fp32).

The other LLaMA serving test files share this file's model pairs
(``llama_pair``) and prompts (``make_prompts``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     load_jax_state)
from test_torch_llama import seeded_state

TOL = 1e-5
TINY = dict(vocab_size=97, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, max_seq_len=256,
            use_flash_attention=False)
KINDS = {"mha": TINY, "gqa": dict(TINY, num_kv_heads=2),
         "tied": dict(TINY, tie_embeddings=True)}
_PAIRS = {}


def llama_pair(kind="mha"):
    """One shared (JAX, port) tiny LLaMA pair per kind, in eval mode:
    no test changes the weights, and the JAX engines over one model share
    their compiled tick programs."""
    if kind not in _PAIRS:
        cfg = KINDS[kind]
        jmodel = JaxLlama(JaxLlamaConfig(**cfg))
        jmodel.eval()
        state = seeded_state(jmodel)
        jmodel.set_state_dict(state)
        tmodel = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu").eval()
        load_jax_state(tmodel, state)
        _PAIRS[kind] = (jmodel, tmodel)
    return _PAIRS[kind]


def make_prompts(lengths, seed, vocab=TINY["vocab_size"]):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, vocab, n)] for n in lengths]


@pytest.mark.parametrize("use_cache", [True, False],
                         ids=["cache", "recompute"])
@pytest.mark.parametrize("kind", ["mha", "gqa", "tied"])
def test_generate_greedy_matches_jax(kind, use_cache):
    jmodel, tmodel = llama_pair(kind)
    ids = np.asarray(make_prompts([7, 7], seed=3), np.int32)
    n_new = 9 if use_cache else 5     # the JAX recompute loop runs eagerly
    ref = np.asarray(jmodel.generate(ids, max_new_tokens=n_new,
                                     use_cache=use_cache).numpy())
    got = tmodel.generate(torch.from_numpy(ids), max_new_tokens=n_new,
                          use_cache=use_cache)
    assert got.dtype == torch.int32 and got.shape == (2, 7 + n_new)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(set(got[:, 7:].flatten().tolist())) > 1     # not degenerate


def test_cached_generate_equals_full_recompute():
    _, tmodel = llama_pair("gqa")
    ids = torch.tensor(make_prompts([12, 12, 12], seed=4))
    cached = tmodel.generate(ids, max_new_tokens=12)
    assert torch.equal(cached, tmodel.generate(ids, max_new_tokens=12,
                                               use_cache=False))
    assert torch.equal(cached[:, :12], ids)


@pytest.mark.parametrize("kind", ["mha", "gqa"])
def test_cached_block_step_matches_jax(kind):
    """One block at pos 5 over 3 new positions with a partly filled
    cache: the output and both updated caches against the JAX block."""
    jmodel, tmodel = llama_pair(kind)
    cfg = KINDS[kind]
    nkv = cfg.get("num_kv_heads", cfg["num_heads"])
    hd = cfg["hidden_size"] // cfg["num_heads"]
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, cfg["hidden_size"]).astype(np.float32)
    kc = rng.randn(2, 10, nkv, hd).astype(np.float32)
    vc = rng.randn(2, 10, nkv, hd).astype(np.float32)
    jout, jcache = jmodel.model.layers[1](
        Tensor(jnp.asarray(x)), cache={"k": jnp.asarray(kc),
                                       "v": jnp.asarray(vc)}, pos=5)
    cache = {"k": torch.from_numpy(kc.copy()),
             "v": torch.from_numpy(vc.copy())}
    with torch.inference_mode():
        out, same = tmodel.model.layers[1](torch.from_numpy(x), cache=cache,
                                           pos=5)
    assert same is cache
    np.testing.assert_allclose(out.numpy(), np.asarray(jout.numpy()),
                               atol=TOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), atol=TOL, rtol=0)


def test_sampled_generate_needs_a_generator_and_reproduces():
    _, tmodel = llama_pair("mha")
    ids = torch.tensor(make_prompts([6], seed=6))
    with pytest.raises(ValueError, match="torch.Generator"):
        tmodel.generate(ids, max_new_tokens=4, temperature=0.8)

    def draw(seed, use_cache=True):
        gen = torch.Generator().manual_seed(seed)
        return tmodel.generate(ids, max_new_tokens=10, temperature=1.5,
                               use_cache=use_cache, generator=gen)

    assert torch.equal(draw(1), draw(1))
    assert torch.equal(draw(1), draw(1, use_cache=False))
    assert not torch.equal(draw(1), draw(2))
