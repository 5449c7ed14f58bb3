"""Attention functionals (counterpart of ``paddle_tpu/nn/functional/flash_attention.py``).

Layout follows the JAX package: q/k/v are (batch, seq, num_heads,
head_dim). ``flash_attention`` with no dropout goes to
``ops/cuda/flash_attention.py::flash_attention_fwd``: with grad enabled
and an input that requires it, through the autograd Function (the K1
forward kernel, then the K2/K3 backward kernels); otherwise K1 alone.
CUDA tensors launch the Hopper kernels, CPU tensors run their plain
versions. Dropout draws from the caller's ``torch.Generator``. Both
functionals are on amp's white list and cast q/k/v (and an additive
mask) for it. The JAX
package's sequence-length crossover and its measured choice between
implementations are TPU measurements and have no counterpart here.

On Paddle ``Tensor``s each is one op through ``core.dispatch.call`` over
the same body (so a CUDA tensor launches the kernels or raises, and only
a CPU tensor takes the plain versions), with dropout drawn from the
device's Paddle-API generator; the mask takes no gradient.

``flash_attn_unpadded`` (a segment mask over packed tokens) and
``flash_attention_with_sparse_mask`` take the plain path, as the JAX
package takes XLA's for them; ``sdp_kernel`` is accepted and chooses
nothing.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from ...amp.state import amp_cast
from ...core import dispatch
from ...core.generator import default_generator
from ...core.tensor import Tensor, as_tensor
from ...ops.cuda.flash_attention import flash_attention_fwd
from ._op import call
from .common import dropout as _dropout

NEG_INF = -1e30


def _sdpa_plain(q, k, v, bias=None, causal=False, dropout_p=0.0,
                generator: Optional[torch.Generator] = None, scale=None):
    """Plain attention in BSHD layout with an fp32 softmax (mirrors the
    JAX package's ``_sdpa_xla``): logits in fp32, -1e30 mask, bottom-right
    causal ``tril(k=t-s)``."""
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = (torch.einsum("bshd,bthd->bhst", q, k) * sc).float()
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        s, t = logits.shape[-2], logits.shape[-1]
        keep = torch.ones((s, t), dtype=torch.bool,
                          device=q.device).tril(diagonal=t - s)
        logits = logits.masked_fill(~keep, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p > 0.0:
        probs = _dropout(probs, dropout_p, generator=generator)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _paddle_generator(q: Tensor, generator, drawing: bool):
    """The generator a Paddle-API call draws its dropout from."""
    if generator is not None or not drawing:
        return generator
    return default_generator(q._data.device)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None,
                    generator: Optional[torch.Generator] = None):
    """Returns ``(out, None)``. With dropout active (``dropout > 0`` while
    training) the plain path runs, as in the JAX package, drawing from
    ``generator``; otherwise the flash kernels."""
    if isinstance(query, Tensor):
        g = _paddle_generator(query, generator, dropout > 0.0 and training)
        out = dispatch.call("flash_attention", lambda q, k, v: flash_attention(
            q, k, v, dropout, causal, training=training, generator=g)[0],
            [query, key, value])
        return out, None
    query, key, value = amp_cast("flash_attention", query, key, value)
    if dropout > 0.0 and training:
        out = _sdpa_plain(query, key, value, causal=causal,
                          dropout_p=dropout, generator=generator)
    else:
        out, _ = flash_attention_fwd(query, key, value, causal=causal)
    return out, None


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None,
                                 generator: Optional[torch.Generator] = None):
    """softmax(q·kᵀ/√d)·v over BSHD q/k/v. With no mask and no active
    dropout this is the flash kernels; a mask (additive, or boolean where
    True keeps) or dropout (from ``generator``) takes the plain path."""
    if isinstance(query, Tensor):
        g = _paddle_generator(query, generator, dropout_p > 0.0 and training)
        ins = [query, key, value]
        if attn_mask is not None:
            ins.append(as_tensor(attn_mask))
        return dispatch.call(
            "scaled_dot_product_attention",
            lambda q, k, v, *m: scaled_dot_product_attention(
                q, k, v, m[0] if m else None, dropout_p, is_causal, training,
                generator=g), ins,
            differentiable_mask=[True, True, True, False][:len(ins)])
    query, key, value, attn_mask = amp_cast(
        "scaled_dot_product_attention", query, key, value, attn_mask)
    drop = dropout_p if training else 0.0
    if attn_mask is None and drop == 0.0:
        out, _ = flash_attention_fwd(query, key, value, causal=is_causal)
        return out
    bias = attn_mask
    if bias is not None and bias.dtype == torch.bool:
        bias = torch.zeros(bias.shape, dtype=torch.float32,
                           device=bias.device).masked_fill(~bias, NEG_INF)
    return _sdpa_plain(query, key, value, bias=bias, causal=is_causal,
                       dropout_p=drop, generator=generator)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Attention over packed (total_tokens, H, d) q/k/v, each token seeing
    only the keys of its own sequence (``cu_seqlens_*`` are the
    cumulative lengths): the plain path over a segment mask, as the JAX
    package computes it (never its Pallas kernel). Returns (out, None)."""
    def body(q, k, v, cq, ck):
        pos_q = torch.arange(q.shape[0], device=q.device)
        pos_k = torch.arange(k.shape[0], device=k.device)
        seg_q = torch.searchsorted(cq[1:].contiguous(), pos_q, right=True)
        seg_k = torch.searchsorted(ck[1:].contiguous(), pos_k, right=True)
        logits = (torch.einsum("qhd,khd->hqk", q, k) * scale).float()
        same = seg_q[:, None] == seg_k[None, :]
        if causal:
            off_q = pos_q - cq.long()[seg_q]
            off_k = pos_k - ck.long()[seg_k]
            same = same & (off_q[:, None] >= off_k[None, :])
        probs = torch.softmax(logits.masked_fill(~same[None], NEG_INF),
                              dim=-1).to(q.dtype)
        return torch.einsum("hqk,khd->qhd", probs, v)
    out = call("flash_attn_unpadded", body, [query, key, value, cu_seqlens_q,
                                             cu_seqlens_k],
               mask=[True, True, True, False, False])
    return out, None


def flash_attention_with_sparse_mask(query, key, value,
                                     attn_mask_start_row_indices,
                                     attn_mask_start_row=0, dropout_p=0.0,
                                     is_causal=True, training=True,
                                     name=None):
    """Attention over BSHD q/k/v where key column j is hidden from the
    query rows at or past its start row (``attn_mask_start_row_indices``,
    (B, H, Sk)), on top of the causal mask: the plain path."""
    def body(q, k, v, idx):
        logits = (torch.einsum("bshd,bthd->bhst", q, k)
                  / math.sqrt(q.shape[-1])).float()
        s, t = logits.shape[-2], logits.shape[-1]
        rows = torch.arange(s, device=q.device)[:, None]
        cols = torch.arange(t, device=q.device)[None, :]
        keep = rows >= cols if is_causal else torch.ones(
            (s, t), dtype=torch.bool, device=q.device)
        keep = keep[None, None] & (rows[None, None] < idx[:, :, None, :])
        probs = torch.softmax(logits.masked_fill(~keep, NEG_INF),
                              dim=-1).to(q.dtype)
        return torch.einsum("bhst,bthd->bshd", probs, v)
    return call("flash_attention_with_sparse_mask", body,
                [query, key, value, attn_mask_start_row_indices],
                mask=[True, True, True, False])


@contextlib.contextmanager
def sdp_kernel(*args, **kwargs):
    """Accepted for Paddle's API; the choice of kernel is the port's own
    (the flash kernels wherever the JAX package would take Pallas)."""
    yield


__all__ = ["flash_attention", "scaled_dot_product_attention",
           "flash_attn_unpadded", "flash_attention_with_sparse_mask",
           "sdp_kernel"]
