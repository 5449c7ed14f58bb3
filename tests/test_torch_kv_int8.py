"""int8 KV pages in the port against the JAX package's.

``kv_quantize_int8`` / ``kv_dequantize_int8`` must be bitwise equal to
the JAX helpers (round half to even on both sides); int8 paged attention
within 1e-5 of the JAX function in fp32, with its int8 pages and scales
equal; the int8 engine's greedy tokens, across preemption and
re-prefill (which rewrite quantized pages), equal to the JAX int8
engine's; and ``kv_bytes_per_token`` equal to the JAX engine's.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.inference import LlamaPagedEngine as JaxEngine
from paddle_tpu.nn.functional.paged_attention import \
    block_multihead_attention as jax_bmha
from paddle_tpu.ops.pallas import serving as JS
from paddle_tpu_torch.inference import LlamaPagedEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn.functional import paged_attention as PA
from paddle_tpu_torch.ops.cuda.serving import (KV_QMAX, kv_dequantize_int8,
                                               kv_quantize_int8)
from test_torch_llama_generate import TINY, llama_pair, make_prompts
from test_torch_llama_serving import CASES, serve
from test_torch_paged_attention import CASES as PAGED_CASES
from test_torch_paged_attention import _inputs

ATOL = 1e-5


def _kv_rows(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(3, 5, 4, 16).astype(np.float32) * 3.0
    x[0, 0] = 0.0                              # scale clamps to 1e-8
    # scale exactly 1: the halves must round to even on both sides
    x[0, 1, 0, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -3.5, 126.5, -126.5]
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_dequantize_bitwise_equal_jax(dtype):
    x32 = _kv_rows(0)
    x = torch.from_numpy(x32).to(getattr(torch, dtype))
    jx = np.asarray(x.float().numpy())
    import jax.numpy as jnp
    jq, js = JS.kv_quantize_int8(jnp.asarray(jx).astype(dtype))
    q, s = kv_quantize_int8(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[0, 1, 0, :8].tolist() == [127, 0, 2, 2, 0, -4, 126, -126]
    assert int(q.abs().max()) == KV_QMAX
    deq = kv_dequantize_int8(q, s)
    assert deq.dtype == torch.float32      # fp32, not the pages' type
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(JS.kv_dequantize_int8(jq, js)))


@pytest.mark.parametrize("name", sorted(PAGED_CASES))
def test_int8_paged_attention_matches_jax(name):
    T, H, KVH, seq_lens, causal = PAGED_CASES[name]
    q, kc, vc, tables, sl, nk, nv = _inputs(T, H, KVH, seq_lens, seed=3)
    kq, ks = (a.numpy() for a in kv_quantize_int8(torch.from_numpy(kc)))
    vq, vs = (a.numpy() for a in kv_quantize_int8(torch.from_numpy(vc)))
    ref = jax_bmha(q, kq, vq, tables, sl, new_k=nk, new_v=nv, causal=causal,
                   k_scale=ks, v_scale=vs)
    got = PA.block_multihead_attention(
        torch.from_numpy(q), *(torch.from_numpy(a.copy())
                               for a in (kq, vq, tables, sl)),
        new_k=torch.from_numpy(nk), new_v=torch.from_numpy(nv), causal=causal,
        k_scale=torch.from_numpy(ks.copy()),
        v_scale=torch.from_numpy(vs.copy()))
    assert len(got) == len(ref) == 5
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0].numpy()),
                               atol=ATOL, rtol=0)
    for mine, theirs in zip(got[1:3], ref[1:3]):         # int8 pages
        np.testing.assert_array_equal(mine.numpy(),
                                      np.asarray(theirs.numpy()))
    # the scales: compiled, XLA divides by 127 as a product with 1/127,
    # one fp32 unit from the division that the JAX source writes (and
    # its eager helper computes, held bitwise above)
    for mine, theirs in zip(got[3:], ref[3:]):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs.numpy()),
                                   rtol=2 ** -23, atol=0)


def test_write_selection_is_computed_once_per_call(monkeypatch):
    """Four tensors are written with int8 pages (K, V and both scales);
    the kept-write selection (a host sync) is made once."""
    calls = []
    real = PA._write_index
    monkeypatch.setattr(PA, "_write_index",
                        lambda *a: calls.append(1) or real(*a))
    q, kc, vc, tables, sl, nk, nv = _inputs(*PAGED_CASES["chunk"][:4])
    scales = torch.ones(kc.shape[:3])
    PA.block_multihead_attention(
        torch.from_numpy(q), torch.zeros(kc.shape, dtype=torch.int8),
        torch.zeros(vc.shape, dtype=torch.int8), torch.from_numpy(tables),
        torch.from_numpy(sl), new_k=torch.from_numpy(nk),
        new_v=torch.from_numpy(nv), k_scale=scales, v_scale=scales.clone())
    assert len(calls) == 1


@pytest.mark.parametrize("kind,name", [
    ("mha", "more_requests_than_slots"), ("gqa", "mixed_lengths"),
    ("mha", "preemption"), ("gqa", "block_growth")])
def test_int8_engine_tokens_match_jax_int8_engine(kind, name):
    lengths, n_new, geometry = CASES[name]
    jmodel, tmodel = llama_pair(kind)
    prompts = make_prompts(lengths, seed=len(name) + 1)
    ref, jeng = serve(JaxEngine, jmodel, prompts, n_new, kv_dtype="int8",
                      **geometry)
    got, eng = serve(LlamaPagedEngine, tmodel, prompts, n_new,
                     kv_dtype=torch.int8, device="cpu", **geometry)
    assert got == ref and eng._ticks == jeng._ticks
    kp, ks = eng.kc[0]
    assert kp.dtype == torch.int8 and ks.dtype == torch.float32
    assert ks.shape == (geometry["num_blocks"], geometry["block_size"],
                        eng.num_kv_heads)
    if name == "preemption":
        assert eng.evictions >= 1


@pytest.mark.parametrize("kv", [None, "bfloat16", "int8"])
@pytest.mark.parametrize("kind", ["mha", "gqa"])
def test_kv_bytes_per_token_matches_jax(kind, kv):
    jmodel, tmodel = llama_pair(kind)
    geometry = dict(max_batch=1, block_size=4, num_blocks=4,
                    max_blocks_per_seq=2)
    jeng = JaxEngine(jmodel, kv_dtype=kv, **geometry)
    eng = LlamaPagedEngine(tmodel, kv_dtype=kv, device="cpu", **geometry)
    assert eng.kv_bytes_per_token == jeng.kv_bytes_per_token > 0


def test_int8_engine_on_a_bf16_model():
    """int8 pages under bf16 weights: the pages hold the quantized bf16
    activations and the scales stay fp32; the tokens are finite ids."""
    model = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu",
                             dtype="bfloat16").eval()
    got, eng = serve(LlamaPagedEngine, model, make_prompts([6, 9], seed=2),
                     [5, 5], kv_dtype="int8", device="cpu",
                     **CASES["mixed_lengths"][2])
    assert eng.kv_dtype == torch.int8
    assert [len(t) for t in got] == [5, 5]
    assert all(0 <= t < TINY["vocab_size"] for toks in got for t in toks)
