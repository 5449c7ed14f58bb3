"""The port's phase-split scheduler against the JAX package's.

Under a ``prefill_token_budget`` the engine advances at most the budget's
chunks of prefill per tick and decodes every tick. The tokens must equal
the unbudgeted engine's, and the tick count, the deferred chunks and the
scheduled prefill/decode tokens must equal the JAX engine's under the
same budget (tiny LLaMA of ``test_torch_llama_generate``). While a long
prompt prefills, a running request gains one token every tick.
"""
import numpy as np
import pytest

from paddle_tpu.inference import LlamaPagedEngine as JaxEngine
from paddle_tpu.serving import Scheduler as JaxScheduler
from paddle_tpu.serving import SchedulerConfig as JaxSchedulerConfig
from paddle_tpu_torch.inference import LlamaPagedEngine
from paddle_tpu_torch.serving import Scheduler, SchedulerConfig
from test_torch_llama_generate import llama_pair, make_prompts

GEOMETRY = dict(max_batch=3, block_size=4, num_blocks=48,
                max_blocks_per_seq=12)


def _serve(engine_cls, model, prompts, n_new, **kw):
    eng = engine_cls(model, **dict(GEOMETRY, **kw))
    rids = [eng.add_request(p, max_new_tokens=n) for p, n in zip(prompts,
                                                                  n_new)]
    out = eng.run_to_completion(max_ticks=500)
    return [out[r] for r in rids], eng


def _counters(eng):
    s = eng.scheduler
    return (eng._ticks, s.deferred_chunks, s.prefill_tokens, s.decode_tokens)


@pytest.mark.parametrize("budget", [1, 4, 8])
@pytest.mark.parametrize("kind", ["mha", "gqa"])
def test_budgeted_engine_matches_jax_and_unbudgeted(kind, budget):
    jmodel, tmodel = llama_pair(kind)
    prompts = make_prompts([3, 17, 9, 22, 5], seed=budget)
    n_new = [6, 4, 7, 3, 5]
    plain, plain_eng = _serve(LlamaPagedEngine, tmodel, prompts, n_new,
                              device="cpu")
    ref, jeng = _serve(JaxEngine, jmodel, prompts, n_new,
                       scheduler=JaxSchedulerConfig(
                           prefill_token_budget=budget))
    got, eng = _serve(LlamaPagedEngine, tmodel, prompts, n_new,
                      scheduler=SchedulerConfig(prefill_token_budget=budget),
                      device="cpu")
    assert got == plain == ref
    assert _counters(eng) == _counters(jeng)
    assert eng.scheduler.deferred_chunks > 0 and eng._ticks > plain_eng._ticks
    assert plain_eng.scheduler.deferred_chunks == 0
    share = eng.scheduler.phase_share()
    assert share["prefill"] + share["decode"] == pytest.approx(1.0)


def test_decode_is_not_starved_by_a_long_prefill():
    _, tmodel = llama_pair("mha")
    eng = LlamaPagedEngine(tmodel, scheduler=Scheduler(
        SchedulerConfig(prefill_token_budget=4)), device="cpu", **GEOMETRY)
    short = eng.add_request(make_prompts([3], seed=1)[0], max_new_tokens=20)
    eng.step()                                   # short: prefilled, token 1
    running = eng.slots[0]
    assert running.rid == short and len(running.generated) == 2
    eng.add_request(make_prompts([33], seed=2)[0], max_new_tokens=2)
    ticks = 0
    while eng.queue or eng._prefilling:          # 9 chunks at 1 a tick
        before = len(running.generated)
        eng.step()
        assert len(running.generated) == before + 1
        ticks += 1
    assert ticks == 9 and eng.scheduler.deferred_chunks > 0


def test_scheduler_bookkeeping_matches_jax():
    for budget in (None, 3, 4, 17):
        for bs in (4, 16):
            assert (Scheduler(SchedulerConfig(budget)).chunk_quota(bs)
                    == JaxScheduler(JaxSchedulerConfig(budget))
                    .chunk_quota(bs))
    mine = Scheduler(SchedulerConfig(share_window_ticks=3))
    theirs = JaxScheduler(JaxSchedulerConfig(share_window_ticks=3))
    rng = np.random.RandomState(0)
    for tick in range(7):
        for _ in range(rng.randint(0, 3)):
            phase = ("prefill", "decode")[rng.randint(2)]
            tokens, secs = int(rng.randint(1, 40)), float(rng.rand())
            for s in (mine, theirs):
                s.note_phase(phase, tokens, secs)
        for s in (mine, theirs):
            s.note_deferred(tick % 3)
        assert mine.tick_phase_seconds() == theirs.tick_phase_seconds()
        mine.end_tick()
        theirs.end_tick()
        assert mine.phase_share() == theirs.phase_share()
    assert (mine.prefill_tokens, mine.decode_tokens, mine.deferred_chunks) \
        == (theirs.prefill_tokens, theirs.decode_tokens,
            theirs.deferred_chunks)


@pytest.mark.parametrize("kw", [dict(prefill_token_budget=0),
                                dict(min_prefill_chunks=0),
                                dict(share_window_ticks=0)])
def test_config_validation_matches_jax(kw):
    with pytest.raises(ValueError) as jerr:
        JaxSchedulerConfig(**kw)
    with pytest.raises(ValueError) as terr:
        SchedulerConfig(**kw)
    assert str(terr.value) == str(jerr.value)
