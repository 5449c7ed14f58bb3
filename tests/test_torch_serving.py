"""The port's PagedEngine against the JAX package's, on the same weights.

A tiny GPT with numpy-seeded weights (``test_torch_gpt.seeded_state``)
serves the same requests in the JAX ``GPTPagedEngine`` and in the port's
(on CPU tensors); the greedy tokens must be identical. The port's engine is also held against the port's own
full-recompute greedy loop through ``model(ids)``.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.inference import GPTPagedEngine as JaxEngine
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu_torch.inference import (BlockManager, GPTPagedEngine,
                                        PagedEngine, RequestStatus)
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, load_jax_state
from test_torch_gpt import TINY, seeded_state

_MODELS = {}


def _models():
    """One shared (JAX, port) pair: no test mutates the weights, and the
    JAX engines over one model share compiled tick programs."""
    if "pair" not in _MODELS:
        jmodel = JaxGPT(JaxGPTConfig(**TINY))
        jmodel.eval()
        state = seeded_state(jmodel)
        jmodel.set_state_dict(state)
        tmodel = GPTForCausalLM(GPTConfig(**TINY), device="cpu").eval()
        load_jax_state(tmodel, state)
        _MODELS["pair"] = (jmodel, tmodel)
    return _MODELS["pair"]


def _prompts(lengths, seed):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, TINY["vocab_size"], n)]
            for n in lengths]


def _serve(engine_cls, model, prompts, n_new, **geometry):
    eng = engine_cls(model, **geometry)
    rids = [eng.add_request(p, max_new_tokens=n) for p, n in zip(prompts,
                                                                  n_new)]
    out = eng.run_to_completion(max_ticks=500)
    return [out[r] for r in rids], eng


# name: (prompt lengths, max_new_tokens, engine geometry)
CASES = {
    "short_prompt": ([5], [6], dict(max_batch=2, block_size=8,
                                    num_blocks=16, max_blocks_per_seq=4)),
    "multi_chunk_left_pad": ([11, 19], [5, 5], dict(
        max_batch=2, block_size=4, num_blocks=32, max_blocks_per_seq=8)),
    "more_requests_than_slots": ([3, 9, 14, 6, 10], [6, 4, 5, 7, 3], dict(
        max_batch=2, block_size=4, num_blocks=32, max_blocks_per_seq=8)),
    "block_growth": ([6], [14], dict(max_batch=1, block_size=4,
                                     num_blocks=16, max_blocks_per_seq=8)),
    "preemption": ([4, 4], [6, 6], dict(max_batch=2, block_size=4,
                                        num_blocks=5, max_blocks_per_seq=4)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_greedy_tokens_match_jax_engine(name):
    lengths, n_new, geometry = CASES[name]
    jmodel, tmodel = _models()
    prompts = _prompts(lengths, seed=len(name))
    ref, _ = _serve(JaxEngine, jmodel, prompts, n_new, **geometry)
    got, eng = _serve(PagedEngine, tmodel, prompts, n_new, device="cpu",
                      **geometry)
    assert got == ref
    assert eng.bm.available == geometry["num_blocks"] - 1   # all released
    assert len({t for toks in got for t in toks}) > 1       # not degenerate


def _full_recompute(model, prompt, n_new):
    ids = list(prompt)
    out = []
    with torch.inference_mode():
        for _ in range(n_new):
            logits = model(torch.tensor([ids]))
            nxt = int(torch.argmax(logits[0, -1]))
            out.append(nxt)
            ids.append(nxt)
    return out


def test_engine_matches_full_recompute_loop():
    _, tmodel = _models()
    prompts = _prompts([7, 13, 2], seed=5)
    got, _ = _serve(GPTPagedEngine, tmodel, prompts, [8, 6, 9],
                    max_batch=2, block_size=4, num_blocks=32,
                    max_blocks_per_seq=8, device="cpu")
    for p, toks in zip(prompts, got):
        assert toks == _full_recompute(tmodel, p, len(toks))


def test_eos_stops_early():
    _, tmodel = _models()
    prompt = _prompts([5], seed=9)[0]
    ref = _full_recompute(tmodel, prompt, 10)
    eng = PagedEngine(tmodel, max_batch=1, block_size=4, num_blocks=16,
                      max_blocks_per_seq=8, eos_id=ref[2], device="cpu")
    rid = eng.add_request(prompt, max_new_tokens=10)
    assert eng.run_to_completion()[rid] == ref[:ref.index(ref[2]) + 1]


def test_request_validation_and_never_fitting():
    _, tmodel = _models()
    eng = PagedEngine(tmodel, max_batch=1, block_size=4, num_blocks=4,
                      max_blocks_per_seq=2, device="cpu")
    with pytest.raises(ValueError, match="non-empty"):
        eng.add_request([])
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.add_request([1], max_new_tokens=0)
    with pytest.raises(ValueError, match="position table"):
        eng.add_request([1] * 60, max_new_tokens=10)
    with pytest.raises(ValueError, match="top_p"):
        eng.add_request([1, 2], temperature=0.7, top_p=0.0)
    with pytest.raises(ValueError, match="temperature"):
        eng.add_request([1, 2], temperature=-0.7)
    bad = eng.add_request(list(range(1, 30)), max_new_tokens=4)
    assert "blocks" in eng.rejected[bad] and not eng.queue
    rid = eng.add_request([1, 2, 3], max_new_tokens=2)
    out = eng.run_to_completion()
    assert len(out[rid]) == 2 and bad not in out


def test_block_manager_and_statuses():
    bm = BlockManager(5)
    a = bm.allocate(3)
    assert 0 not in a and len(set(a)) == 3 and bm.available == 1
    with pytest.raises(MemoryError):
        bm.allocate(2)
    bm.release(a)
    assert bm.available == 4
    assert RequestStatus.FINISHED == "FINISHED"


def test_engine_rejects_model_on_another_device():
    _, tmodel = _models()
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="lives on"):
            PagedEngine(tmodel)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PagedEngine(tmodel)
