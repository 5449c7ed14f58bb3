"""The port's paged attention against the JAX package's.

Same numpy-seeded queries, new K/V, block tables and random starting
caches go through ``paddle_tpu``'s ``block_multihead_attention`` and the
port's; the outputs and both updated caches must agree (fp32).
"""
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional.paged_attention import \
    block_multihead_attention as jax_bmha
from paddle_tpu_torch.nn.functional.paged_attention import \
    block_multihead_attention

ATOL = 1e-5

# name: (T, H, KVH, seq_lens, causal)
CASES = {
    "decode": (1, 2, 2, [5, 9, 1], True),
    "chunk": (4, 2, 2, [4, 8, 13], True),
    "padded_rows": (4, 2, 2, [2, 0, 7], True),   # seq_len < T: writes dropped
    "gqa": (3, 4, 2, [3, 10, 16], True),
    "non_causal": (2, 2, 2, [6, 2, 11], False),
}


def _inputs(T, H, KVH, seq_lens, seed=0):
    rng = np.random.RandomState(seed)
    B, D, nb, bs, max_blocks = len(seq_lens), 8, 16, 4, 4
    q = rng.randn(B, T, H, D).astype(np.float32)
    kc = rng.randn(nb, bs, KVH, D).astype(np.float32)
    vc = rng.randn(nb, bs, KVH, D).astype(np.float32)
    nk = rng.randn(B, T, KVH, D).astype(np.float32)
    nv = rng.randn(B, T, KVH, D).astype(np.float32)
    # distinct physical blocks per row (block 0 stays the trash block)
    tables = (1 + rng.permutation(nb - 1)[:B * max_blocks]).reshape(
        B, max_blocks).astype(np.int32)
    return q, kc, vc, tables, np.asarray(seq_lens, np.int32), nk, nv


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    T, H, KVH, seq_lens, causal = CASES[name]
    q, kc, vc, tables, sl, nk, nv = _inputs(T, H, KVH, seq_lens)
    j_out, j_kc, j_vc = jax_bmha(q, kc, vc, tables, sl, new_k=nk, new_v=nv,
                                 causal=causal)
    t_kc, t_vc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    out, o_kc, o_vc = block_multihead_attention(
        torch.from_numpy(q), t_kc, t_vc, torch.from_numpy(tables),
        torch.from_numpy(sl), new_k=torch.from_numpy(nk),
        new_v=torch.from_numpy(nv), causal=causal)
    assert o_kc is t_kc and o_vc is t_vc          # updated in place
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out.numpy()),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_kc.numpy(), np.asarray(j_kc.numpy()),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_vc.numpy(), np.asarray(j_vc.numpy()),
                               atol=ATOL, rtol=0)
    for b, n in enumerate(seq_lens):
        if n == 0:
            assert np.all(out.numpy()[b] == 0.0)


def test_read_only_attention_matches_jax():
    q, kc, vc, tables, sl, _, _ = _inputs(2, 4, 2, [5, 12, 16], seed=1)
    j_out, _, _ = jax_bmha(q, kc, vc, tables, sl, causal=True)
    out, _, _ = block_multihead_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(tables), torch.from_numpy(sl), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out.numpy()),
                               atol=ATOL, rtol=0)


def test_int8_pages_are_a_later_slice():
    """int8 pages came with slice 8: both scales are needed, and the call
    returns the scales beside the caches (held to JAX in
    test_torch_kv_int8.py)."""
    q, kc, vc, tables, sl, nk, nv = _inputs(1, 2, 2, [3, 4, 5])
    kq = torch.zeros(kc.shape, dtype=torch.int8)
    vq = torch.zeros(vc.shape, dtype=torch.int8)
    scales = torch.ones(kc.shape[:3])
    args = (torch.from_numpy(q), kq, vq, torch.from_numpy(tables),
            torch.from_numpy(sl))
    for one in (dict(k_scale=scales), dict(v_scale=scales)):
        with pytest.raises(ValueError, match="both k_scale and v_scale"):
            block_multihead_attention(*args, **one)
    out = block_multihead_attention(*args, new_k=torch.from_numpy(nk),
                                    new_v=torch.from_numpy(nv),
                                    k_scale=scales, v_scale=scales.clone())
    assert len(out) == 5 and out[1] is kq and out[3] is scales
    assert torch.isfinite(out[0]).all() and kq.abs().max() == 127
