"""GPT-2 style decoder-only transformer (counterpart of ``paddle_tpu/models/gpt.py``).

Same configuration fields and the same attribute names as the JAX model,
so state-dict keys line up (``models/convert.py`` copies weights across).
Attention is the flash-attention functional, which launches the Hopper
flash kernels on the card: K1 forward, and K2/K3 on backward when the
model trains. ``GPTForCausalLM(ids, labels=ids)`` returns the logits and
the shifted next-token loss; with ``fused_loss``, ``(None, loss)`` from
the chunked LM-head loss against the tied ``wte``. ``recompute``
checkpoints each block (``models/_remat.py``). Dropout draws from a
``torch.Generator`` that ``GPTModel`` owns on its device, seeded from the
constructor's ``seed``. The linears and norms are the port's layers, so
amp casts their inputs.

With ``mp_degree`` > 1 (after ``fleet.init`` with that ``mp_degree``)
the model is tensor parallel over the mp group, as the JAX ``_linears``
builds it: ``qkv_proj`` and ``fc1`` column-parallel, ``out_proj`` and
``fc2`` row-parallel, ``wte`` vocab-parallel (``distributed.fleet.mpu``'s
torch-level layers). Rank r holds heads [r H/n, (r+1) H/n): its
``qkv_proj`` shard is the q, k and v columns of those heads (the JAX
attention splits q/k/v on the global last dim), and its
``state_dict()`` holds its shards. The init draws the full weights from
the same CPU generator and keeps this rank's part, so the model equals
the one-card model of the same seed. The tied head gives vocab-sharded
logits: without labels they are gathered over mp (the full logits);
with labels the loss is ``ParallelCrossEntropy``'s (the full logits are
never gathered) and the logits returned are this rank's vocab shard.
Attention dropout draws from the model-parallel stream (seed + 1024 +
``MP_SEED_STRIDE`` x the mp rank), the rest from ``seed``. Sequence
parallelism, context parallelism and the fused loss under mp are later
slices and raise.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as TF

from ..core.dtype import convert_dtype
from ..core.generator import make_generator, normal_
from ..core.place import DeviceLike, resolve_device
from ..nn import functional as F
from ..nn.layer import TorchLayerNorm, TorchLinear
from ._remat import remat_block

LN_EPS = 1e-5


def _mp(cfg: "GPTConfig"):
    """The mp group of a tensor-parallel config (None for mp_degree 1);
    raises when the parallel environment's mp degree differs."""
    if cfg.mp_degree == 1:
        return None
    from ..distributed.fleet.mpu.mp_ops import mp_group
    g = mp_group()
    if g is None or g.nranks != cfg.mp_degree:
        raise RuntimeError(
            f"GPTConfig(mp_degree={cfg.mp_degree}) needs fleet.init with "
            f"mp_degree={cfg.mp_degree} first (the model-parallel group "
            f"has {1 if g is None else g.nranks} ranks)")
    return g


def _linears(cfg: "GPTConfig"):
    """(column, row, vocab-embedding) classes by mp_degree, as the JAX
    ``_linears`` picks them (None, None, None for mp_degree 1)."""
    if cfg.mp_degree == 1:
        return None, None, None
    from ..distributed.fleet.mpu import mp_layers
    return (mp_layers.TorchColumnParallelLinear,
            mp_layers.TorchRowParallelLinear,
            mp_layers.TorchVocabParallelEmbedding)


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    intermediate_size: int = 0      # 0 -> 4*hidden
    dropout: float = 0.0
    use_flash_attention: bool = True
    mp_degree: int = 1
    sequence_parallel: bool = False
    recompute: bool = False
    fused_loss: bool = False
    context_parallel: str = ""

    def __post_init__(self):
        if self.intermediate_size == 0:
            self.intermediate_size = 4 * self.hidden_size
        if self.context_parallel not in ("", "ring", "ulysses"):
            raise ValueError(
                f"context_parallel must be '', 'ring' or 'ulysses', got "
                f"{self.context_parallel!r}")
        later = [name for name, on in (
            ("sequence_parallel (the sequence-parallel slice)",
             self.sequence_parallel),
            ("context_parallel (the sep-axis slice: ring and Ulysses "
             "attention)", bool(self.context_parallel)),
            ("fused_loss with mp_degree > 1 (a vocab-parallel fused loss)",
             self.fused_loss and self.mp_degree > 1)) if on]
        if later:
            raise NotImplementedError(f"later slice: {', '.join(later)}")


def gpt2_small(**kw) -> GPTConfig:
    return GPTConfig(**kw)


def gpt2_medium(**kw) -> GPTConfig:
    kw.setdefault("hidden_size", 1024)
    kw.setdefault("num_layers", 24)
    kw.setdefault("num_heads", 16)
    return GPTConfig(**kw)


class GPTAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.generator = generator
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.num_heads = cfg.num_heads // cfg.mp_degree    # this rank's
        self.use_flash = cfg.use_flash_attention
        self.dropout = cfg.dropout
        h = cfg.hidden_size
        col, row, _ = _linears(cfg)
        if col is not None:
            g = _mp(cfg)
            self.qkv_proj = col(h, 3 * h, gather_output=False, groups=3,
                                mp_group=g, device=device, dtype=dtype)
            self.out_proj = row(h, h, input_is_parallel=True, mp_group=g,
                                device=device, dtype=dtype)
        else:
            self.qkv_proj = TorchLinear(h, 3 * h, device=device, dtype=dtype)
            self.out_proj = TorchLinear(h, h, device=device, dtype=dtype)

    def forward(self, x):
        b, s, _ = x.shape
        h = self.num_heads * self.head_dim
        q, k, v = self.qkv_proj(x).split(h, dim=-1)
        # views into the qkv projection: the flash kernel reads them
        # through their strides, without a copy
        q = q.view(b, s, self.num_heads, self.head_dim)
        k = k.view(b, s, self.num_heads, self.head_dim)
        v = v.view(b, s, self.num_heads, self.head_dim)
        if self.use_flash:
            out, _ = F.flash_attention(q, k, v, dropout=self.dropout,
                                       causal=True, training=self.training,
                                       generator=self.generator)
        else:
            out = F.scaled_dot_product_attention(
                q, k, v, is_causal=True, dropout_p=self.dropout,
                training=self.training, generator=self.generator)
        return self.out_proj(out.reshape(b, s, h))


class GPTMLP(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        h, ffn = cfg.hidden_size, cfg.intermediate_size
        col, row, _ = _linears(cfg)
        if col is not None:
            g = _mp(cfg)
            self.fc1 = col(h, ffn, gather_output=False, mp_group=g,
                           device=device, dtype=dtype)
            self.fc2 = row(ffn, h, input_is_parallel=True, mp_group=g,
                           device=device, dtype=dtype)
        else:
            self.fc1 = TorchLinear(h, ffn, device=device, dtype=dtype)
            self.fc2 = TorchLinear(ffn, h, device=device, dtype=dtype)

    def forward(self, x):
        return self.fc2(TF.gelu(self.fc1(x), approximate="tanh"))


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None,
                 attn_generator: Optional[torch.Generator] = None):
        super().__init__()
        h = cfg.hidden_size
        self.generator = generator
        self.ln1 = TorchLayerNorm(h, eps=LN_EPS, device=device, dtype=dtype)
        self.attn = GPTAttention(cfg, device, dtype,
                                 attn_generator or generator)
        self.ln2 = TorchLayerNorm(h, eps=LN_EPS, device=device, dtype=dtype)
        self.mlp = GPTMLP(cfg, device, dtype)
        self.dropout = cfg.dropout

    def forward(self, x):
        y = self.attn(self.ln1(x))
        if self.dropout > 0:
            y = F.dropout(y, p=self.dropout, training=self.training,
                          generator=self.generator)
        x = x + y
        y = self.mlp(self.ln2(x))
        if self.dropout > 0:
            y = F.dropout(y, p=self.dropout, training=self.training,
                          generator=self.generator)
        return x + y


class GPTModel(nn.Module):
    """Embeddings, blocks and the final norm. Owns the dropout generator
    (``self.generator``) on ``device``, seeded with ``seed``, and under
    mp the attention's (``self.mp_generator``)."""

    def __init__(self, cfg: GPTConfig, device=None, dtype=None,
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.generator = make_generator(seed, device or "cpu")
        self.mp_generator = None
        h = cfg.hidden_size
        _, _, vocab = _linears(cfg)
        if vocab is not None:
            from ..distributed.fleet.mpu.random import MP_SEED_STRIDE
            g = _mp(cfg)
            self.mp_generator = make_generator(
                seed + 1024 + MP_SEED_STRIDE * g.rank, device or "cpu")
            self.wte = vocab(cfg.vocab_size, h, mp_group=g, device=device,
                             dtype=dtype)
        else:
            self.wte = nn.Embedding(cfg.vocab_size, h, device=device,
                                    dtype=dtype)
        self.wpe = nn.Embedding(cfg.max_seq_len, h, device=device,
                                dtype=dtype)
        self.blocks = nn.ModuleList([GPTBlock(cfg, device, dtype,
                                              self.generator,
                                              self.mp_generator)
                                     for _ in range(cfg.num_layers)])
        self.ln_f = TorchLayerNorm(h, eps=LN_EPS, device=device, dtype=dtype)

    def forward(self, input_ids):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        x = self.wte(input_ids) + self.wpe(pos)
        for blk in self.blocks:
            x = remat_block(blk, x) if self.cfg.recompute else blk(x)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """LM head tied to ``gpt.wte``; loss = next-token cross entropy. Built
    on ``device`` (default the card; ``device="cpu"`` asks for the CPU)
    with GPT-2's init drawn from a CPU generator seeded with ``seed``:
    N(0, 0.02) weights, the residual projections scaled by
    1/sqrt(2*num_layers), zero biases, unit norms. The dropout generator
    is seeded with ``seed`` too."""

    def __init__(self, cfg: GPTConfig, device: DeviceLike = None,
                 dtype="float32", seed: int = 0):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        dtype = convert_dtype(dtype)
        self.gpt = GPTModel(cfg, device, dtype, seed)
        self._init_weights(make_generator(seed))

    def _init_weights(self, gen: torch.Generator):
        from ..distributed.fleet.mpu.mp_layers import _TorchParallel
        resid_std = 0.02 / math.sqrt(2 * self.cfg.num_layers)
        with torch.no_grad():
            for name, mod in self.named_modules():
                std = (resid_std if name.endswith(("out_proj", "fc2"))
                       else 0.02)
                if isinstance(mod, _TorchParallel):
                    # the full weight's draws, then this rank's part
                    full = torch.empty(mod.full_shape("weight"))
                    mod.load_full("weight", normal_(full, std, gen))
                    if getattr(mod, "bias", None) is not None:
                        mod.bias.zero_()
                elif isinstance(mod, nn.Linear):
                    normal_(mod.weight, std, gen)
                    mod.bias.zero_()
                elif isinstance(mod, nn.Embedding):
                    normal_(mod.weight, 0.02, gen)
                elif isinstance(mod, nn.LayerNorm):
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()

    def forward(self, input_ids, labels=None):
        """Logits (B, S, vocab); with ``labels``, ``(logits, loss)`` where
        the loss predicts ``labels[:, 1:]`` from positions ``:-1``, or
        ``(None, loss)`` with ``fused_loss``."""
        h = self.gpt(input_ids)
        if self.cfg.mp_degree > 1:
            return self._tp_head(h, labels)
        if labels is not None and self.cfg.fused_loss:
            loss = F.fused_linear_cross_entropy(
                h[:, :-1, :].reshape(-1, self.cfg.hidden_size),
                self.gpt.wte.weight, labels[:, 1:].reshape(-1),
                transpose_y=True)
            return None, loss
        logits = F.matmul(h, self.gpt.wte.weight, transpose_y=True)
        if labels is None:
            return logits
        v = logits.shape[-1]
        loss = F.cross_entropy(logits[:, :-1, :].reshape(-1, v),
                               labels[:, 1:].reshape(-1))
        return logits, loss

    def _tp_head(self, h, labels):
        """The tied head under mp: this rank's vocab shard of the logits;
        gathered without labels, else with ParallelCrossEntropy's loss."""
        from ..distributed.fleet.mpu import mp_ops
        from ..distributed.fleet.mpu.mp_layers import parallel_cross_entropy
        g = self.gpt.wte.group
        logits = F.matmul(mp_ops._c_identity(h, g), self.gpt.wte.weight,
                          transpose_y=True)
        if labels is None:
            return mp_ops._c_concat(logits, g, axis=-1)
        lab = labels[:, 1:]
        nll = parallel_cross_entropy(logits[:, :-1, :], lab, g)
        valid = lab != -100
        return logits, nll.sum() / valid.sum().clamp_min(1)

    def num_params(self) -> int:
        """Parameters of the whole model (under mp: every rank's shards
        of the split ones, the replicated ones once)."""
        from ..distributed.fleet.mpu.mp_layers import is_split
        return sum(p.numel() * (self.cfg.mp_degree if is_split(p) else 1)
                   for p in self.parameters())

    def flops_per_token(self) -> float:
        """Dense training FLOPs a token ~= 6*N + 12*L*h*s (forward 2N,
        backward 4N, attention at the full context, forward and
        backward)."""
        c = self.cfg
        attn = 12 * c.num_layers * c.hidden_size * c.max_seq_len
        return 6 * self.num_params() + attn
