"""LLaMA-family decoder (counterpart of ``paddle_tpu/models/llama.py``).

Same configuration fields and attribute names as the JAX model, so
state-dict keys line up (``models/convert.py`` copies weights across).
RMSNorm, rotary embedding (rotate-half), GQA by repeating the KV heads,
the SwiGLU MLP, and the flash-attention functional (K1 forward, K2/K3
backward on the card). ``LlamaForCausalLM(ids, labels=ids)`` returns the
logits and the shifted next-token loss. Through ``jit.to_static`` with
``FLAGS_enable_fusion`` the fusion pass rewrites each q/k projection and
its rope onto ``fused_rope_proj`` (K7) and each residual add and the norm
after it onto ``fused_residual_norm`` (K4). ``fused_loss`` computes the
chunked LM-head loss (``(None, loss)``), against ``lm_head`` or the tied
embedding; ``recompute`` checkpoints each block (``models/_remat.py``).
The linears are the port's ``TorchLinear``, so amp casts their inputs.
``generate`` decodes greedily or by temperature, with a KV cache (a
prefill, then a Python loop of (B, 1) steps: the JAX package's
``lax.scan``) or by full recompute; the paged engine serves the model
through ``inference/serving.py``'s ``_LlamaArch``. Tensor, sequence and
context parallelism are later slices and raise.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import torch
from torch import nn

from ..core import dispatch
from ..core.dtype import convert_dtype
from ..core.generator import make_generator, normal_
from ..core.place import DeviceLike, resolve_device
from ..core.tensor import Tensor
from ..nn import functional as F
from ..nn.layer import TorchLinear, TorchRMSNorm
from ._remat import remat_block


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 0            # 0 -> = num_heads (MHA); < heads = GQA
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    use_flash_attention: bool = True
    tie_embeddings: bool = False
    mp_degree: int = 1
    sequence_parallel: bool = False
    context_parallel: str = ""
    recompute: bool = False
    fused_loss: bool = False

    def __post_init__(self):
        if self.num_kv_heads == 0:
            self.num_kv_heads = self.num_heads
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be divisible by num_kv_heads")
        if self.context_parallel not in ("", "ring", "ulysses"):
            raise ValueError(f"bad context_parallel "
                             f"{self.context_parallel!r}")
        later = [name for name, on in (
            ("mp_degree > 1", self.mp_degree > 1),
            ("sequence_parallel", self.sequence_parallel),
            ("context_parallel", bool(self.context_parallel))) if on]
        if later:
            raise NotImplementedError(f"later slice: {', '.join(later)}")


def llama_7b(**kw) -> LlamaConfig:
    return LlamaConfig(**kw)


def llama_tiny(**kw) -> LlamaConfig:
    kw.setdefault("vocab_size", 512)
    kw.setdefault("hidden_size", 128)
    kw.setdefault("intermediate_size", 256)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("max_seq_len", 128)
    return LlamaConfig(**kw)


def llama2_13b(**kw) -> LlamaConfig:
    kw.setdefault("hidden_size", 5120)
    kw.setdefault("intermediate_size", 13824)
    kw.setdefault("num_layers", 40)
    kw.setdefault("num_heads", 40)
    return LlamaConfig(**kw)


def llama2_70b(**kw) -> LlamaConfig:
    kw.setdefault("hidden_size", 8192)
    kw.setdefault("intermediate_size", 28672)
    kw.setdefault("num_layers", 80)
    kw.setdefault("num_heads", 64)
    kw.setdefault("num_kv_heads", 8)   # GQA
    return LlamaConfig(**kw)


def rope_rotate(a: torch.Tensor, theta: float,
                pos_offset: Union[int, torch.Tensor]) -> torch.Tensor:
    """The rope rotation of a (B, S, H, D) tensor, rotate-half: channel i
    pairs with channel i + D/2 (the JAX code's convention; its docstring's
    "(even, odd) pairs" is not what it computes). Positions are
    ``pos_offset + s``; ``pos_offset`` is an int or a (B,) tensor. Angles
    and products in fp32, the result in a's dtype. The one copy of the
    rotation: ``rotary_embedding`` and the fused ``rope_proj`` composite
    both call it."""
    b, s, h, d = a.shape
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=a.device) / half))
    if isinstance(pos_offset, torch.Tensor):
        off = pos_offset.to(device=a.device, dtype=torch.float32).reshape(-1)
    else:
        off = torch.full((1,), float(pos_offset), device=a.device)
    positions = off[:, None] + torch.arange(s, dtype=torch.float32,
                                            device=a.device)[None, :]
    pos = positions[:, :, None] * freqs[None, None, :]
    cos = torch.cos(pos)[:, :, None, :]          # (B|1, S, 1, half)
    sin = torch.sin(pos)[:, :, None, :]
    x1, x2 = a[..., :half], a[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(a.dtype)


def rotary_embedding(x, theta: float = 10000.0, pos_offset=0):
    """RoPE on (B, S, H, D). ``pos_offset`` is a Python int or a per-batch
    (B,) tensor; only an int offset lets the fusion pass fold the rope into
    the projection before it. On a Paddle ``Tensor`` it is op
    ``rotary_embedding``, whose attrs ``theta``/``pos_offset`` (an int
    offset only, as in the JAX package) the fusion pass matches on; a
    Tensor offset is an input of the op."""
    if isinstance(x, Tensor):
        if isinstance(pos_offset, Tensor):
            return dispatch.call("rotary_embedding", lambda a, off: (
                rope_rotate(a, theta, off)), [x, pos_offset],
                differentiable_mask=[True, False])
        attrs = None
        if isinstance(pos_offset, int) and not isinstance(pos_offset, bool):
            attrs = {"theta": float(theta), "pos_offset": int(pos_offset)}
        return dispatch.call("rotary_embedding", lambda a, **_: rope_rotate(
            a, theta, pos_offset), [x], attrs=attrs)
    return rope_rotate(x, theta, pos_offset)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.num_heads = cfg.num_heads
        self.num_kv_heads = cfg.num_kv_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        h = cfg.hidden_size
        kv = self.num_kv_heads * self.head_dim
        kw = dict(bias=False, device=device, dtype=dtype)
        self.q_proj = TorchLinear(h, h, **kw)
        self.k_proj = TorchLinear(h, kv, **kw)
        self.v_proj = TorchLinear(h, kv, **kw)
        self.o_proj = TorchLinear(h, h, **kw)

    def forward(self, x, cache=None, pos: int = 0):
        """Self-attention of x (B, S, hidden) at positions pos..pos+S-1.
        With ``cache`` ({"k", "v"}: (B, total, KVH, D)), returns
        ``(out, cache)`` after writing this step's K/V at ``pos``."""
        b, s, h = x.shape
        hd, nh, nkv = self.head_dim, self.num_heads, self.num_kv_heads
        q = self.q_proj(x).view(b, s, nh, hd)
        k = self.k_proj(x).view(b, s, nkv, hd)
        v = self.v_proj(x).view(b, s, nkv, hd)
        q = rotary_embedding(q, self.cfg.rope_theta, pos_offset=pos)
        k = rotary_embedding(k, self.cfg.rope_theta, pos_offset=pos)
        if cache is not None:
            return self._cached_attention(x, q, k, v, cache, pos)
        if nkv != nh:   # GQA: kv head j serves query heads j*rep .. j*rep+rep-1
            rep = nh // nkv
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        if self.cfg.use_flash_attention:
            out, _ = F.flash_attention(q, k, v, causal=True)
        else:
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.o_proj(out.reshape(b, s, h))

    def _cached_attention(self, x, q, k, v, cache, pos: int):
        """Decode-time attention against the KV cache: writes this step's
        K/V at ``pos`` (in place) and attends each query over the cached
        positions at or before its own, with an fp32 softmax under a -1e30
        mask. Returns (out, cache)."""
        b, s, h = x.shape
        nh, nkv = self.num_heads, self.num_kv_heads
        kc, vc = cache["k"], cache["v"]
        kc[:, pos:pos + s] = k.to(kc.dtype)
        vc[:, pos:pos + s] = v.to(vc.dtype)
        kk, vv = kc, vc
        if nkv != nh:   # GQA: kv head j serves query heads j*rep .. +rep-1
            rep = nh // nkv
            kk = kc.repeat_interleave(rep, dim=2)
            vv = vc.repeat_interleave(rep, dim=2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.to(kk.dtype),
                              kk).float() * (1.0 / math.sqrt(self.head_dim))
        kpos = torch.arange(kk.shape[1], device=x.device)
        qpos = pos + torch.arange(s, device=x.device)
        logits = logits.masked_fill(kpos[None, :] > qpos[:, None], -1e30)
        # probabilities in q's dtype, as the JAX function casts them
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(vv.dtype), vv)
        return self.o_proj(out.reshape(b, s, h).to(x.dtype)), cache


class LlamaMLP(nn.Module):
    """SwiGLU MLP: down(silu(gate(x)) * up(x))."""

    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        h, ffn = cfg.hidden_size, cfg.intermediate_size
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gate_proj = TorchLinear(h, ffn, **kw)
        self.up_proj = TorchLinear(h, ffn, **kw)
        self.down_proj = TorchLinear(ffn, h, **kw)

    def forward(self, x):
        return self.down_proj(F.swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        h = cfg.hidden_size
        kw = dict(epsilon=cfg.rms_eps, device=device, dtype=dtype)
        self.input_layernorm = TorchRMSNorm(h, **kw)
        self.self_attn = LlamaAttention(cfg, device, dtype)
        self.post_attention_layernorm = TorchRMSNorm(h, **kw)
        self.mlp = LlamaMLP(cfg, device, dtype)

    def forward(self, x, cache=None, pos: int = 0):
        if cache is not None:
            att, cache = self.self_attn(self.input_layernorm(x), cache=cache,
                                        pos=pos)
            x = x + att
            return x + self.mlp(self.post_attention_layernorm(x)), cache
        x = x + self.self_attn(self.input_layernorm(x))
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         device=device, dtype=dtype)
        self.layers = nn.ModuleList([LlamaBlock(cfg, device, dtype)
                                     for _ in range(cfg.num_layers)])
        self.norm = TorchRMSNorm(cfg.hidden_size, epsilon=cfg.rms_eps,
                                 device=device, dtype=dtype)

    def forward(self, input_ids):
        x = self.embed_tokens(input_ids)
        for blk in self.layers:
            x = remat_block(blk, x) if self.cfg.recompute else blk(x)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """Decoder plus LM head (``lm_head``, or the embedding with
    ``tie_embeddings``); loss = next-token cross entropy. Built on
    ``device`` (default the card; ``device="cpu"`` asks for the CPU) with
    the JAX model's init drawn from a CPU generator seeded with ``seed``:
    N(0, 0.02) linear and embedding weights, unit norm weights."""

    def __init__(self, cfg: LlamaConfig, device: DeviceLike = None,
                 dtype="float32", seed: int = 0):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        dtype = convert_dtype(dtype)
        self.model = LlamaModel(cfg, device, dtype)
        self.lm_head = None if cfg.tie_embeddings else TorchLinear(
            cfg.hidden_size, cfg.vocab_size, bias=False, device=device,
            dtype=dtype)
        gen = make_generator(seed)
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (nn.Linear, nn.Embedding)):
                    normal_(mod.weight, 0.02, gen)

    def forward(self, input_ids, labels=None):
        """Logits (B, S, vocab); with ``labels``, ``(logits, loss)`` where
        the loss predicts ``labels[:, 1:]`` from positions ``:-1``, or
        ``(None, loss)`` with ``fused_loss``."""
        h = self.model(input_ids)
        head = self.model.embed_tokens if self.lm_head is None \
            else self.lm_head
        if labels is not None and self.cfg.fused_loss:
            # both heads hold (vocab, hidden): the embedding table, and
            # nn.Linear's (out, in) weight
            loss = F.fused_linear_cross_entropy(
                h[:, :-1, :].reshape(-1, self.cfg.hidden_size), head.weight,
                labels[:, 1:].reshape(-1), transpose_y=True)
            return None, loss
        logits = self._head(h)
        if labels is None:
            return logits
        v = logits.shape[-1]
        loss = F.cross_entropy(logits[:, :-1, :].reshape(-1, v),
                               labels[:, 1:].reshape(-1))
        return logits, loss

    def _head(self, h):
        if self.lm_head is None:
            return F.matmul(h, self.model.embed_tokens.weight,
                            transpose_y=True)
        return self.lm_head(h)

    def _decode_logits(self, tokens, cache, pos: int):
        """One cached step over tokens (B, t) at positions pos..pos+t-1;
        returns the last position's logits (B, vocab)."""
        h = self.model.embed_tokens(tokens)
        for blk, layer_cache in zip(self.model.layers, cache):
            h, _ = blk(h, cache=layer_cache, pos=pos)
        return self._head(self.model.norm(h))[:, -1, :]

    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0, use_cache: bool = True,
                 generator: Optional[torch.Generator] = None):
        """Autoregressive decode; returns (B, prompt + max_new_tokens) ids.

        ``use_cache=True`` prefills a KV cache once and then runs one
        (B, 1) step a token against it; ``use_cache=False`` recomputes the
        whole context every token (the ground truth). Greedy with
        ``temperature=0``; otherwise each token is drawn from
        softmax(logits / temperature) with ``generator``, which the caller
        must give (the port keeps no global RNG)."""
        if temperature > 0 and generator is None:
            raise ValueError("generate: sampling (temperature > 0) needs a "
                             "torch.Generator")
        ids = torch.as_tensor(input_ids, device=self.model.norm.weight.device)

        def pick(last):
            if temperature > 0:
                probs = torch.softmax(last.float() / temperature, dim=-1)
                draw = torch.multinomial(probs.to(generator.device), 1,
                                         generator=generator)
                return draw.to(ids.device, ids.dtype)
            return torch.argmax(last, dim=-1, keepdim=True).to(ids.dtype)

        with torch.inference_mode():
            if not use_cache:
                for _ in range(max_new_tokens):
                    ids = torch.cat([ids, pick(self(ids)[:, -1, :])], dim=1)
                return ids
            cfg = self.cfg
            b, prompt_len = ids.shape
            total = prompt_len + max_new_tokens
            hd = cfg.hidden_size // cfg.num_heads
            # an fp32 cache, as the JAX package's
            cache = [{name: torch.zeros((b, total, cfg.num_kv_heads, hd),
                                        dtype=torch.float32, device=ids.device)
                      for name in ("k", "v")} for _ in range(cfg.num_layers)]
            logits = self._decode_logits(ids, cache, 0)
            new = []
            for pos in range(prompt_len, total):
                nxt = pick(logits)
                new.append(nxt)
                if pos + 1 < total:
                    logits = self._decode_logits(nxt, cache, pos)
            return torch.cat([ids] + new, dim=1)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self) -> float:
        """Dense training FLOPs a token ~= 6*N + 12*L*h*s (forward 2N,
        backward 4N, attention at the full context)."""
        c = self.cfg
        return 6 * self.num_params() + 12 * c.num_layers * c.hidden_size \
            * c.max_seq_len
