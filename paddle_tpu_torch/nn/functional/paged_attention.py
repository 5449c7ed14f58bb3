"""Paged (block-table) KV-cache attention for serving (counterpart of
``paddle_tpu/nn/functional/paged_attention.py``).

The cache is one (num_blocks, block_size, KVH, D) tensor per K/V. A step
(1) writes the step's new K/V into the slots its block table names and
(2) gathers each sequence's pages into a contiguous (S_max, KVH, D) view
and runs masked attention with an fp32 softmax. GQA/MQA: H a multiple of
KVH. The JAX package computes this with plain array ops and no Pallas
kernel, so it is plain PyTorch here too.

Unlike the JAX function, which returns new cache arrays, the caches are
updated in place (and returned, so the call reads the same).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30

__all__ = ["block_multihead_attention"]


def _append(cache, new, block_tables, seq_lens, T):
    """Write new (B, T, KVH, D) at positions [len-T, len) of each row.
    Writes at negative positions (padded rows, idle lanes with seq_len 0)
    or past the table / the pool are dropped, as ``mode="drop"`` does in
    the JAX scatter."""
    nb, bs = cache.shape[:2]
    max_blocks = block_tables.shape[1]
    pos = seq_lens[:, None] - T + torch.arange(T, device=seq_lens.device)
    ok = pos >= 0
    slot = pos.clamp_min(0) // bs
    ok &= slot < max_blocks
    blk = torch.gather(block_tables, 1, slot.clamp_max(max_blocks - 1))
    ok &= (blk >= 0) & (blk < nb)
    off = pos.clamp_min(0) % bs
    # index_put_ has no drop mode: select the kept writes (one nonzero,
    # which waits for the device)
    sel = ok.nonzero(as_tuple=True)
    cache[blk[sel], off[sel]] = new[sel].to(cache.dtype)


def block_multihead_attention(q, key_cache, value_cache, block_tables,
                              seq_lens, new_k=None, new_v=None, causal=True,
                              scale=None, k_scale=None, v_scale=None,
                              name=None):
    """Attend over paged KV history (and first append this step's KV).

    q: (B, T, H, D) queries for the T newest positions of each sequence.
    key_cache / value_cache: (num_blocks, block_size, KVH, D) float pages.
    block_tables: (B, max_blocks_per_seq) physical block ids.
    seq_lens: (B,) lengths INCLUDING the T new tokens.
    new_k / new_v: (B, T, KVH, D), written at positions [len-T, len).

    Returns (out (B, T, H, D), key_cache, value_cache); the caches are the
    same tensors, updated in place.
    """
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "int8 KV pages (k_scale/v_scale) come with a later slice")
    B, T, H, D = q.shape
    nb, bs, KVH, _ = key_cache.shape
    if H % KVH:
        raise ValueError(f"H={H} not a multiple of KVH={KVH}")
    group = H // KVH
    sl = seq_lens.to(torch.int64)
    bt = block_tables.to(torch.int64)
    if new_k is not None:
        _append(key_cache, new_k, bt, sl, T)
        _append(value_cache, new_v, bt, sl, T)

    s_max = bt.shape[1] * bs
    sc = scale if scale is not None else 1.0 / (D ** 0.5)
    safe = bt.clamp(0, nb - 1)
    k = key_cache[safe].reshape(B, s_max, KVH, D).float()
    v = value_cache[safe].reshape(B, s_max, KVH, D).float()
    qg = q.reshape(B, T, KVH, group, D).float()
    s = torch.einsum("btkgd,bskd->btkgs", qg, k) * sc
    jpos = torch.arange(s_max, device=q.device)
    if causal:
        qpos = sl[:, None] - T + torch.arange(T, device=q.device)
        mask = jpos[None, None, :] <= qpos[:, :, None]          # (B, T, s)
    else:
        mask = (jpos[None, :] < sl[:, None])[:, None, :].expand(B, T, s_max)
    # -1e30 (not -inf) and explicit zeroing of rows that see nothing: a
    # padded row (length <= 0) must give 0, not NaN
    s = s.masked_fill(~mask[:, :, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("btkgs,bskd->btkgd", p, v)
    any_valid = mask.any(dim=-1)[:, :, None, None, None]
    o = torch.where(any_valid, o, torch.zeros_like(o))
    return o.reshape(B, T, H, D).to(q.dtype), key_cache, value_cache
