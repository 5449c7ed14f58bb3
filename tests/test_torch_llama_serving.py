"""The port's LlamaPagedEngine against the JAX package's, on the same weights.

The tiny LLaMA pairs of ``test_torch_llama_generate`` (MHA, GQA, tied
head) serve the same requests in the JAX ``LlamaPagedEngine`` and in the
port's (on CPU tensors): the greedy tokens and the tick counts must be
identical, over mixed lengths, left-padded multi-chunk prefill, more
requests than slots, block growth, preemption and EOS. The port's
engine is also held against the port's own ``generate``.
"""
import pytest
import torch

from paddle_tpu.inference import LlamaPagedEngine as JaxEngine
from paddle_tpu_torch.inference import (GPTPagedEngine, LlamaPagedEngine,
                                        PagedEngine)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from test_torch_llama_generate import TINY, llama_pair, make_prompts

# name: (prompt lengths, max_new_tokens, engine geometry)
GEOMETRY = dict(max_batch=2, block_size=4, num_blocks=32,
                max_blocks_per_seq=8)
CASES = {
    "mixed_lengths": ([5, 11, 3], [6, 4, 7], GEOMETRY),
    "more_requests_than_slots": ([3, 9, 14, 6, 10], [6, 4, 5, 7, 3],
                                 GEOMETRY),
    "block_growth": ([6], [14], GEOMETRY),
    "preemption": ([4, 4], [6, 6], dict(GEOMETRY, num_blocks=5,
                                        max_blocks_per_seq=4)),
}


def serve(engine_cls, model, prompts, n_new, **kw):
    eng = engine_cls(model, **kw)
    rids = [eng.add_request(p, max_new_tokens=n) for p, n in zip(prompts,
                                                                  n_new)]
    out = eng.run_to_completion(max_ticks=500)
    return [out[r] for r in rids], eng


@pytest.mark.parametrize("kind", ["mha", "gqa"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_greedy_tokens_match_jax_engine(name, kind):
    lengths, n_new, geometry = CASES[name]
    jmodel, tmodel = llama_pair(kind)
    prompts = make_prompts(lengths, seed=len(name))
    ref, jeng = serve(JaxEngine, jmodel, prompts, n_new, **geometry)
    got, eng = serve(LlamaPagedEngine, tmodel, prompts, n_new, device="cpu",
                     **geometry)
    assert got == ref
    assert eng._ticks == jeng._ticks
    assert eng.bm.available == geometry["num_blocks"] - 1   # all released
    assert len({t for toks in got for t in toks}) > 1       # not degenerate
    if name == "preemption":
        assert eng.evictions >= 1


def test_tied_head_matches_jax_engine():
    jmodel, tmodel = llama_pair("tied")
    prompts = make_prompts([7, 2, 12], seed=8)
    ref, _ = serve(JaxEngine, jmodel, prompts, [5, 5, 5], **GEOMETRY)
    got, _ = serve(PagedEngine, tmodel, prompts, [5, 5, 5], device="cpu",
                   **GEOMETRY)
    assert got == ref


def test_engine_matches_generate():
    _, tmodel = llama_pair("gqa")
    prompts = make_prompts([7, 13, 2], seed=5)
    got, _ = serve(LlamaPagedEngine, tmodel, prompts, [8, 6, 9],
                   device="cpu", **GEOMETRY)
    for p, toks in zip(prompts, got):
        ref = tmodel.generate(torch.tensor([p]), max_new_tokens=len(toks))
        assert toks == ref[0, len(p):].tolist()


def test_eos_stops_early():
    jmodel, tmodel = llama_pair("mha")
    prompt = make_prompts([5], seed=9)[0]
    ref = tmodel.generate(torch.tensor([prompt]),
                          max_new_tokens=10)[0, 5:].tolist()
    eos = ref[2]
    geometry = dict(GEOMETRY, eos_id=eos)
    got, _ = serve(PagedEngine, tmodel, [prompt], [10], device="cpu",
                   **geometry)
    jgot, _ = serve(JaxEngine, jmodel, [prompt], [10], **geometry)
    assert got[0] == jgot[0] == ref[:ref.index(eos) + 1]


def test_llama_has_no_position_table():
    """LLaMA's positions are rotations: a request longer than
    ``max_seq_len`` is admitted (the JAX engine reads ``max_positions``
    with getattr), and the GPT engine's check stays."""
    _, tmodel = llama_pair("mha")
    eng = LlamaPagedEngine(tmodel, max_batch=1, block_size=32,
                           num_blocks=12, max_blocks_per_seq=10,
                           device="cpu")
    assert not hasattr(eng.arch, "max_positions")
    rid = eng.add_request([1] * 250, max_new_tokens=10)
    assert rid not in eng.rejected and eng.queue
    assert GPTPagedEngine is LlamaPagedEngine is PagedEngine


def test_pages_take_the_model_dtype_and_other_models_raise():
    model = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu",
                             dtype="bfloat16")
    eng = PagedEngine(model, max_batch=1, block_size=4, num_blocks=4,
                      max_blocks_per_seq=2, device="cpu")
    assert eng.kv_dtype == torch.bfloat16
    assert all(c.dtype == torch.bfloat16 for c in eng.kc + eng.vc)
    eng = PagedEngine(model, max_batch=1, block_size=4, num_blocks=4,
                      max_blocks_per_seq=2, kv_dtype="float32",
                      device="cpu")
    assert eng.kc[0].dtype == torch.float32
    with pytest.raises(TypeError, match="LlamaForCausalLM"):
        PagedEngine(torch.nn.Linear(2, 2), device="cpu")
