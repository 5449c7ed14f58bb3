"""Paged (block-table) KV-cache attention for serving (counterpart of
``paddle_tpu/nn/functional/paged_attention.py``).

The cache is one (num_blocks, block_size, KVH, D) tensor per K/V. A step
(1) writes the step's new K/V into the slots its block table names and
(2) gathers each sequence's pages into a contiguous (S_max, KVH, D) view
and runs masked attention with an fp32 softmax. GQA/MQA: H a multiple of
KVH. The JAX package computes this with plain array ops and no Pallas
kernel, so it is plain PyTorch here too.

int8 pages: int8 caches with fp32 sidecar scales ``k_scale``/``v_scale``
of shape (num_blocks, block_size, KVH). The new K/V is quantized on
write (``ops/cuda/serving.py``) and the gathered pages are dequantized
in fp32, the attention's accumulation dtype.

Unlike the JAX function, which returns new cache arrays, the caches (and
scales) are updated in place, and returned, so the call reads the same.
"""
from __future__ import annotations

import torch

from ...ops.cuda.serving import kv_dequantize_int8, kv_quantize_int8

NEG_INF = -1e30

__all__ = ["block_multihead_attention"]


def _write_index(block_tables, seq_lens, T, nb, bs):
    """(blocks, offsets, selection) of the kept writes of new (B, T, ...)
    rows at positions [len-T, len). Writes at negative positions (padded
    rows, idle lanes with seq_len 0) or past the table / the pool are
    dropped, as ``mode="drop"`` does in the JAX scatter. ``index_put_``
    has no drop mode, so the kept writes are selected once here (one
    ``nonzero``, which waits for the device) and every tensor written in
    the call reuses the selection."""
    max_blocks = block_tables.shape[1]
    pos = seq_lens[:, None] - T + torch.arange(T, device=seq_lens.device)
    ok = pos >= 0
    slot = pos.clamp_min(0) // bs
    ok &= slot < max_blocks
    blk = torch.gather(block_tables, 1, slot.clamp_max(max_blocks - 1))
    ok &= (blk >= 0) & (blk < nb)
    off = pos.clamp_min(0) % bs
    sel = ok.nonzero(as_tuple=True)
    return blk[sel], off[sel], sel


def _gather_pages(cache, scale, safe, B, s_max, KVH, D):
    """A sequence's pages as one (B, s_max, KVH, D) fp32 view."""
    if scale is None:
        pages = cache[safe].float()
    else:
        pages = kv_dequantize_int8(cache[safe], scale[safe])
    return pages.reshape(B, s_max, KVH, D)


def block_multihead_attention(q, key_cache, value_cache, block_tables,
                              seq_lens, new_k=None, new_v=None, causal=True,
                              scale=None, k_scale=None, v_scale=None,
                              name=None):
    """Attend over paged KV history (and first append this step's KV).

    q: (B, T, H, D) queries for the T newest positions of each sequence.
    key_cache / value_cache: (num_blocks, block_size, KVH, D) float pages,
    or int8 pages when ``k_scale``/``v_scale`` (num_blocks, block_size,
    KVH) fp32 are given.
    block_tables: (B, max_blocks_per_seq) physical block ids.
    seq_lens: (B,) lengths INCLUDING the T new tokens.
    new_k / new_v: (B, T, KVH, D), written at positions [len-T, len).

    Returns (out (B, T, H, D), key_cache, value_cache), plus (k_scale,
    v_scale) with int8 pages; the caches are the same tensors, updated in
    place.
    """
    quantized = k_scale is not None or v_scale is not None
    if quantized and (k_scale is None or v_scale is None):
        raise ValueError("int8 KV cache needs both k_scale and v_scale")
    B, T, H, D = q.shape
    nb, bs, KVH, _ = key_cache.shape
    if H % KVH:
        raise ValueError(f"H={H} not a multiple of KVH={KVH}")
    group = H // KVH
    sl = seq_lens.to(torch.int64)
    bt = block_tables.to(torch.int64)
    if new_k is not None:
        blk, off, sel = _write_index(bt, sl, T, nb, bs)
        if quantized:
            qk, sk = kv_quantize_int8(new_k[sel])
            qv, sv = kv_quantize_int8(new_v[sel])
            key_cache[blk, off] = qk
            value_cache[blk, off] = qv
            k_scale[blk, off] = sk
            v_scale[blk, off] = sv
        else:
            key_cache[blk, off] = new_k[sel].to(key_cache.dtype)
            value_cache[blk, off] = new_v[sel].to(value_cache.dtype)

    s_max = bt.shape[1] * bs
    sc = scale if scale is not None else 1.0 / (D ** 0.5)
    safe = bt.clamp(0, nb - 1)
    k = _gather_pages(key_cache, k_scale, safe, B, s_max, KVH, D)
    v = _gather_pages(value_cache, v_scale, safe, B, s_max, KVH, D)
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
    out = o.reshape(B, T, H, D).to(q.dtype)
    if quantized:
        return out, key_cache, value_cache, k_scale, v_scale
    return out, key_cache, value_cache
