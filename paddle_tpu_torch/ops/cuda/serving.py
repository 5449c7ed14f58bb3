"""int8 KV (de)quantization and the speculative accept-prefix rule
(counterpart of ``paddle_tpu/ops/pallas/serving.py``).

The JAX file holds ``jnp`` helpers that fuse into the engine's tick
program, not ``pallas_call`` kernels; these are plain PyTorch functions
at the counterpart path, and there is no kernel behind them.

* ``kv_quantize_int8`` / ``kv_dequantize_int8``: symmetric abs-max int8
  over the head dim, one fp32 scale per (position, head); dequantized in
  fp32, the attention's accumulation dtype.
* ``spec_accept_prefix``: the longest prefix of the draft that the
  target model's greedy tokens agree with, capped per slot.
"""
from __future__ import annotations

import torch

__all__ = ["KV_QMAX", "kv_quantize_int8", "kv_dequantize_int8",
           "spec_accept_prefix"]

#: symmetric int8 range for KV payloads (-127..127; -128 unused, so the
#: abs-max element maps to 127 exactly)
KV_QMAX = 127.0


def kv_quantize_int8(x: torch.Tensor):
    """(int8 payload, fp32 scales) of KV activations (..., D): the scale
    is the abs-max over D over 127 (at least 1e-8); ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    x32 = x.float()
    scale = (x32.abs().amax(dim=-1) / KV_QMAX).clamp_min(1e-8)
    q = torch.round(x32 / scale[..., None]).clamp(-KV_QMAX, KV_QMAX)
    return q.to(torch.int8), scale


def kv_dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The payload times its scale, in ``dtype`` (fp32 by default: the
    attention multiplies in fp32)."""
    return q.to(dtype) * scale[..., None].to(dtype)


def spec_accept_prefix(draft: torch.Tensor, greedy: torch.Tensor,
                       max_accept: torch.Tensor):
    """Greedy acceptance of a speculative draft.

    draft: (B, k) tokens fed at positions 1..k of the verify chunk;
    greedy: (B, k+1) the model's next token after each chunk position;
    max_accept: (B,) per-slot cap (0 turns speculation off for a slot).
    Returns ``(n_emit, accepted)``: ``accepted`` is the length of the
    longest prefix with draft == greedy, at most ``max_accept``, and
    ``n_emit = accepted + 1`` (the model's own token after the prefix is
    always emitted).
    """
    k = draft.shape[1]
    match = draft == greedy[:, :k]
    match &= (torch.arange(k, device=draft.device)[None, :]
              < max_accept[:, None].to(torch.int64))
    accepted = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    return accepted + 1, accepted
