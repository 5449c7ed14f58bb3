"""The port's n-gram speculative decoding against the JAX package's.

``NgramProposer`` and ``spec_accept_prefix`` must equal the JAX ones on
random inputs. The speculative engine (tiny LLaMA of
``test_torch_llama_generate``, prompts repeated three times so drafts are
accepted) must give the plain engine's greedy tokens and, on the same
weights, the JAX speculative engine's tokens, ``spec_proposed``,
``spec_accepted`` and tick count. EOS inside an accepted run, the
fallback near a slot's block-table capacity, an all-skipped tick's
eviction, sampling slots on the verify path, and proposers that are
always wrong (every draft page rewritten before it is read) or always
right are covered too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import LlamaPagedEngine as JaxEngine
from paddle_tpu.ops.pallas.serving import \
    spec_accept_prefix as jax_accept_prefix
from paddle_tpu.serving import NgramProposer as JaxNgramProposer
from paddle_tpu_torch.inference import LlamaPagedEngine
from paddle_tpu_torch.ops.cuda.serving import spec_accept_prefix
from paddle_tpu_torch.serving import NgramProposer
from test_torch_llama_generate import llama_pair, make_prompts

GEOMETRY = dict(max_batch=3, block_size=4, num_blocks=64,
                max_blocks_per_seq=12)


def _serve(engine_cls, model, prompts, n_new, requests=None, **kw):
    eng = engine_cls(model, **dict(GEOMETRY, **kw))
    requests = requests or [{}] * len(prompts)
    rids = [eng.add_request(p, max_new_tokens=n, **r)
            for p, n, r in zip(prompts, n_new, requests)]
    out = eng.run_to_completion(max_ticks=500)
    return [out[r] for r in rids], eng


def _repeated(lengths, seed):
    return [p * 3 for p in make_prompts(lengths, seed)]


def test_ngram_proposer_matches_jax():
    rng = np.random.RandomState(0)
    for k, max_n, min_n in ((4, 3, 1), (2, 2, 2), (6, 4, 1), (1, 1, 1)):
        mine = NgramProposer(k=k, max_n=max_n, min_n=min_n)
        theirs = JaxNgramProposer(k=k, max_n=max_n, min_n=min_n)
        for _ in range(100):
            ctx = rng.randint(0, 4, rng.randint(1, 30)).tolist()
            assert mine.propose(ctx) == theirs.propose(ctx)
    assert NgramProposer(k=3).propose([7, 8, 9, 1, 2, 7, 8]) == [9, 1, 2]
    for kw in (dict(k=0), dict(min_n=0), dict(max_n=1, min_n=2)):
        with pytest.raises(ValueError) as jerr:
            JaxNgramProposer(**kw)
        with pytest.raises(ValueError) as terr:
            NgramProposer(**kw)
        assert str(terr.value) == str(jerr.value)


def test_spec_accept_prefix_matches_jax():
    rng = np.random.RandomState(1)
    draft = rng.randint(0, 3, (64, 4)).astype(np.int32)
    greedy = rng.randint(0, 3, (64, 5)).astype(np.int32)
    greedy[::3, :4] = draft[::3]                     # whole drafts match
    max_accept = rng.randint(0, 5, 64).astype(np.int32)
    j_emit, j_acc = jax_accept_prefix(jnp.asarray(draft), jnp.asarray(greedy),
                                      jnp.asarray(max_accept))
    emit, acc = spec_accept_prefix(torch.from_numpy(draft),
                                   torch.from_numpy(greedy),
                                   torch.from_numpy(max_accept))
    np.testing.assert_array_equal(emit.numpy(), np.asarray(j_emit))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(j_acc))
    assert acc.max() == 4 and (emit == acc + 1).all()


@pytest.mark.parametrize("kind,kv", [("mha", None), ("gqa", None),
                                     ("mha", "int8")])
def test_speculative_engine_matches_plain_and_jax(kind, kv):
    jmodel, tmodel = llama_pair(kind)
    prompts = _repeated([4, 6, 3, 5], seed=40)
    n_new = [12, 10, 12, 9]
    plain, _ = _serve(LlamaPagedEngine, tmodel, prompts, n_new, kv_dtype=kv,
                      device="cpu")
    ref, jeng = _serve(JaxEngine, jmodel, prompts, n_new, kv_dtype=kv,
                       speculate="ngram", speculate_k=4)
    got, eng = _serve(LlamaPagedEngine, tmodel, prompts, n_new, kv_dtype=kv,
                      speculate="ngram", speculate_k=4, device="cpu")
    assert got == plain == ref
    assert (eng.spec_proposed, eng.spec_accepted, eng._ticks) == \
        (jeng.spec_proposed, jeng.spec_accepted, jeng._ticks)
    assert eng.spec_proposed > 0


def test_eos_inside_an_accepted_run_stops_exactly():
    jmodel, tmodel = llama_pair("mha")
    prompts = _repeated([5], seed=44)
    base, _ = _serve(LlamaPagedEngine, tmodel, prompts, [10], device="cpu")
    eos = base[0][3]
    plain, _ = _serve(LlamaPagedEngine, tmodel, prompts, [10], eos_id=eos,
                      device="cpu")
    ref, _ = _serve(JaxEngine, jmodel, prompts, [10], eos_id=eos,
                    speculate="ngram")
    got, _ = _serve(LlamaPagedEngine, tmodel, prompts, [10], eos_id=eos,
                    speculate="ngram", device="cpu")
    assert got == plain == ref == [base[0][:base[0].index(eos) + 1]]


def test_near_capacity_falls_back_to_plain_decode():
    """cap = 4 blocks of 4 = 16 positions; prompt 8 + 8 new fills it, so
    the last ticks cannot hold k draft positions and decode plainly."""
    jmodel, tmodel = llama_pair("gqa")
    prompts = [make_prompts([4], seed=45)[0] * 2]
    geometry = dict(num_blocks=64, max_blocks_per_seq=4)
    plain, _ = _serve(LlamaPagedEngine, tmodel, prompts, [8], device="cpu",
                      **geometry)
    ref, jeng = _serve(JaxEngine, jmodel, prompts, [8], speculate="ngram",
                       **geometry)
    eng = LlamaPagedEngine(tmodel, speculate="ngram", device="cpu",
                           **dict(GEOMETRY, **geometry))
    rid = eng.add_request(prompts[0], max_new_tokens=8)
    feasible = []
    out = {}
    while eng.has_work():
        active = [i for i, s in enumerate(eng.slots) if s is not None]
        feasible.append(eng._spec_feasible(active) if active else None)
        out.update(eng.step())
    assert [out[rid]] == plain == ref and eng._ticks == jeng._ticks
    assert False in feasible and max(map(len, eng.slot_blocks)) <= 4


def test_all_skipped_verify_tick_evicts():
    jmodel, tmodel = llama_pair("mha")
    prompts = _repeated([2, 2], seed=46)
    geometry = dict(num_blocks=6, max_blocks_per_seq=5)
    plain, _ = _serve(LlamaPagedEngine, tmodel, prompts, [6, 6],
                      device="cpu", **geometry)
    ref, jeng = _serve(JaxEngine, jmodel, prompts, [6, 6],
                       speculate="ngram", **geometry)
    got, eng = _serve(LlamaPagedEngine, tmodel, prompts, [6, 6],
                      speculate="ngram", device="cpu", **geometry)
    assert got == plain == ref and eng._ticks == jeng._ticks
    assert eng.evictions >= 1 and eng.bm.available == 5


def test_sampling_slots_ride_the_verify():
    """A sampled request beside a speculating greedy one: the verify runs
    with the sampled slot's acceptance off, and both requests get the
    tokens of the engine without speculation."""
    _, tmodel = llama_pair("mha")
    prompts = _repeated([4, 6], seed=47)
    requests = [{}, dict(temperature=0.9, top_p=0.9)]
    base, _ = _serve(LlamaPagedEngine, tmodel, prompts, [10, 10],
                     requests=requests, seed=11, device="cpu")
    got, eng = _serve(LlamaPagedEngine, tmodel, prompts, [10, 10],
                      requests=requests, seed=11, speculate="ngram",
                      device="cpu")
    assert got == base and eng.spec_proposed > 0
    alone, _ = _serve(LlamaPagedEngine, tmodel, prompts[1:], [10],
                      requests=requests[1:], seed=11, speculate="ngram",
                      device="cpu")
    assert alone[0] != base[1]       # the request id keys the draw
    sampled_only, eng = _serve(LlamaPagedEngine, tmodel, prompts, [10, 10],
                               requests=[requests[1]] * 2, seed=11,
                               speculate="ngram", device="cpu")
    assert sampled_only[1] == base[1] and eng.spec_proposed == 0


class _Fixed:
    """A proposer that always drafts from ``table[context length]``."""

    def __init__(self, table, k=3):
        self.table, self.k = table, k

    def propose(self, context):
        return self.table(len(context))[:self.k]


def test_wrong_and_right_proposers():
    """Always wrong: every draft page written by a verify is stale and
    must be rewritten before a query reads it. Always right: k + 1
    tokens a tick."""
    _, tmodel = llama_pair("gqa")
    prompt = make_prompts([6], seed=48)[0]
    plain, plain_eng = _serve(LlamaPagedEngine, tmodel, [prompt], [15],
                              device="cpu")
    full = prompt + plain[0]
    wrong = _Fixed(lambda n: [(t + 1) % 97 for t in full[n:n + 3]])
    got, eng = _serve(LlamaPagedEngine, tmodel, [prompt], [15],
                      speculate=wrong, device="cpu")
    assert got == plain and eng.spec_accepted == 0 and eng.spec_proposed
    right = _Fixed(lambda n: full[n:n + 3])
    got, eng = _serve(LlamaPagedEngine, tmodel, [prompt], [15],
                      speculate=right, device="cpu")
    assert got == plain
    assert eng.spec_accepted > 0 and eng._ticks < plain_eng._ticks - 5
