"""Per-request sampling in the port against the JAX package's.

``nucleus_sample_ids`` takes its uniforms as an argument: fed JAX's own
``jax.random.uniform`` draw, it must pick the ids that the JAX function
picks from the same key. The engine's draws come from a counter-based
hash of (seed, request id, tokens generated, vocabulary index), which
JAX's keys cannot reproduce, so the engine is held to the properties the
JAX engine promises: temperature 0 is greedy, a fixed seed reproduces,
two seeds differ, and neither preemption nor the batch a request runs in
changes its tokens. Validation errors match the JAX engine's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import LlamaPagedEngine as JaxEngine
from paddle_tpu.ops.search import nucleus_sample_ids as jax_nucleus
from paddle_tpu_torch.inference import LlamaPagedEngine
from paddle_tpu_torch.inference.serving import _request_uniforms
from paddle_tpu_torch.ops.search import nucleus_sample_ids
from test_torch_llama_generate import llama_pair, make_prompts

GEOMETRY = dict(max_batch=3, block_size=4, num_blocks=32,
                max_blocks_per_seq=8)
SAMPLED = dict(temperature=0.8, top_p=0.9)


def _probs(B, V, seed, ties=False):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, V) * 2.0
    if ties:   # whole groups of equal probabilities
        logits = np.round(logits)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("p", [0.05, 0.5, 0.9, 1.0])
def test_nucleus_ids_match_jax_on_jax_uniforms(p, ties):
    probs = _probs(16, 97, seed=int(p * 100), ties=ties)
    ps = np.full((16,), p, np.float32)
    for k in range(3):
        key = jax.random.key(k)
        u = jax.random.uniform(key, probs.shape, minval=1e-20, maxval=1.0)
        ref = np.asarray(jax_nucleus(jnp.asarray(probs), jnp.asarray(ps),
                                     key))
        got = nucleus_sample_ids(torch.from_numpy(probs),
                                 torch.from_numpy(ps),
                                 torch.from_numpy(np.asarray(u)))
        assert got.shape == (16, 1)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_nucleus_keeps_the_top_token_and_the_nucleus():
    probs = torch.tensor([[0.1, 0.6, 0.3], [0.5, 0.25, 0.25]])
    u = torch.full((2, 3), 0.5)
    # a nucleus below the top token's mass still keeps the top token
    ids = nucleus_sample_ids(probs, torch.tensor([1e-6, 1e-6]), u)
    assert ids[:, 0].tolist() == [1, 0]
    # p = 0.7 keeps {1, 2} in row 0: token 0 is never drawn
    draws = {int(nucleus_sample_ids(probs[:1], torch.tensor([0.7]),
                                    torch.rand(1, 3, generator=g)
                                    .clamp_min(1e-20))[0, 0])
             for g in [torch.Generator().manual_seed(s) for s in range(40)]}
    assert draws == {1, 2}


def test_request_uniforms_range_and_uniformity():
    rids = torch.arange(1, 65)
    u = _request_uniforms(7, rids, torch.zeros(64, dtype=torch.int64), 4096)
    assert u.dtype == torch.float32 and u.shape == (64, 4096)
    assert float(u.min()) >= 1e-20 and float(u.max()) < 1.0
    counts = torch.histc(u, bins=16, min=0.0, max=1.0)
    expected = u.numel() / 16
    assert float((counts - expected).abs().max()) < 0.03 * expected
    assert abs(float(u.mean()) - 0.5) < 2e-3
    # neighbours in the vocabulary and in the request ids are uncorrelated
    c = np.corrcoef(u[:, :-1].flatten().numpy(), u[:, 1:].flatten().numpy())
    assert abs(c[0, 1]) < 0.01
    c = np.corrcoef(u[:-1].flatten().numpy(), u[1:].flatten().numpy())
    assert abs(c[0, 1]) < 0.01
    # a function of (seed, rid, ngen) only: rows repeat exactly, and each
    # of the three changes the draw
    again = _request_uniforms(7, torch.tensor([5, 5]), torch.tensor([0, 0]),
                              4096)
    assert torch.equal(again[0], u[4]) and torch.equal(again[1], u[4])
    for seed, rid, ngen in ((8, 5, 0), (7, 6, 0), (7, 5, 1)):
        other = _request_uniforms(seed, torch.tensor([rid]),
                                  torch.tensor([ngen]), 4096)
        assert not torch.equal(other[0], u[4])


def _sample(prompts, n_new, seed, requests=None, **geometry):
    _, tmodel = llama_pair("mha")
    eng = LlamaPagedEngine(tmodel, seed=seed, device="cpu",
                           **dict(GEOMETRY, **geometry))
    requests = requests or [SAMPLED] * len(prompts)
    rids = [eng.add_request(p, max_new_tokens=n_new, **r)
            for p, r in zip(prompts, requests)]
    out = eng.run_to_completion(max_ticks=500)
    return [out[r] for r in rids], eng


def test_temperature_zero_is_greedy():
    prompts = make_prompts([5, 9, 3], seed=1)
    greedy, _ = _sample(prompts, 8, 0, requests=[{}] * 3)
    # slot 1 greedy (temperature 0, top_p ignored) beside two sampled slots
    mixed, _ = _sample(prompts, 8, 0, requests=[
        SAMPLED, dict(temperature=0.0, top_p=0.3), SAMPLED])
    assert mixed[1] == greedy[1]
    assert mixed[0] != greedy[0] or mixed[2] != greedy[2]


def test_fixed_seed_reproduces_and_seeds_differ():
    prompts = make_prompts([5, 9, 3], seed=2)
    first, _ = _sample(prompts, 10, 123)
    assert first == _sample(prompts, 10, 123)[0]
    assert first != _sample(prompts, 10, 124)[0]
    assert len({t for toks in first for t in toks}) > 3


def test_batching_and_preemption_do_not_change_sampled_tokens():
    prompts = make_prompts([4, 4], seed=3)
    roomy, _ = _sample(prompts, 6, 5)
    one_slot, _ = _sample(prompts, 6, 5, max_batch=1)
    tight, eng = _sample(prompts, 6, 5, num_blocks=5, max_blocks_per_seq=4)
    assert eng.evictions >= 1
    assert roomy == one_slot == tight


@pytest.mark.parametrize("kw,match", [
    (dict(top_p=0.0), "top_p"), (dict(top_p=1.5), "top_p"),
    (dict(temperature=-0.1), "temperature"),
    (dict(temperature=float("nan")), "temperature"),
    (dict(max_new_tokens=0), "max_new_tokens")])
def test_validation_errors_match_jax(kw, match):
    jmodel, tmodel = llama_pair("mha")
    geometry = dict(max_batch=1, block_size=4, num_blocks=4,
                    max_blocks_per_seq=2)
    with pytest.raises(ValueError, match=match) as jerr:
        JaxEngine(jmodel, **geometry).add_request([1, 2], **kw)
    with pytest.raises(ValueError, match=match) as terr:
        LlamaPagedEngine(tmodel, device="cpu", **geometry).add_request(
            [1, 2], **kw)
    assert str(terr.value) == str(jerr.value)
