"""Transformer layers (counterpart of ``paddle_tpu/nn/layer/transformer.py``):
``MultiHeadAttention`` with its incremental ``Cache`` (self-attention:
each step's k/v concatenated onto it) and ``StaticCache`` (cross-attention:
the memory's k/v projected once), the encoder and decoder layers and
stacks with their ``gen_cache``, and ``Transformer``.

Attention goes through the Paddle-API ``F.scaled_dot_product_attention``:
with no mask and no active dropout that is the flash kernels (K1
forward, K2/K3 backward) on a CUDA tensor, non-causal; a cached decode
step is K1 at one query row against the cache's keys. A mask or active
dropout takes the plain path, as the JAX package takes XLA's.
"""
from __future__ import annotations

import copy

import torch

from ... import ops
from ...core import dispatch
from ...core.place import current_device
from ...core.tensor import Tensor
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .layers import Layer
from .norm import LayerNorm


def _convert_attention_mask(attn_mask):
    """A boolean mask (True keeps) -> an fp32 additive one (0 / -1e30);
    any other mask passes through."""
    if attn_mask is None or attn_mask.dtype != torch.bool:
        return attn_mask
    return dispatch.call(
        "mask_to_bias", lambda m: torch.zeros(
            m.shape, dtype=torch.float32, device=m.device).masked_fill(
                ~m, -1e30), [attn_mask], differentiable_mask=[False])


class MultiHeadAttention(Layer):
    """q/k/v/out projections over [B, S, E] (reference:
    nn/layer/transformer.py MultiHeadAttention). Self-attention without a
    cache runs one (E, 3E) projection, the three weights concatenated, as
    the JAX package does, while the three are plain ``Linear``s."""

    class Cache:
        """The self-attention keys and values so far, [B, T, H, d]."""

        def __init__(self, k, v):
            self.k, self.v = k, v

    class StaticCache:
        """The cross-attention keys and values of the memory."""

        def __init__(self, k, v):
            self.k, self.v = k, v

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        assert self.head_dim * num_heads == embed_dim
        self.dropout = dropout
        self.need_weights = need_weights
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _plain_projections(self) -> bool:
        """Whether q/k/v are plain ``Linear``s, whose weights the
        self-attention path concatenates: a quantized projection
        (``QuantedLinear``) or one whose forward QAT replaced runs as
        its own layer."""
        return all(isinstance(p, Linear)
                   and not getattr(p, "_qat_wrapped", False)
                   for p in (self.q_proj, self.k_proj, self.v_proj))

    def _reshape_heads(self, x):
        b, s = x.shape[0], x.shape[1]
        return ops.reshape(x, [b, s, self.num_heads, self.head_dim])

    def gen_cache(self, key, value=None, type=None):
        """A ``StaticCache`` of ``key``/``value`` projected (``type`` is
        ``StaticCache``), else an empty ``Cache`` [B, 0, H, d] in the
        key's dtype, on its device."""
        if type == MultiHeadAttention.StaticCache:
            k = self._reshape_heads(self.k_proj(key))
            v = self._reshape_heads(self.v_proj(
                value if value is not None else key))
            return self.StaticCache(k, v)
        ref = key._data
        empty = torch.zeros((key.shape[0], 0, self.num_heads, self.head_dim),
                            dtype=ref.dtype, device=ref.device)
        return self.Cache(Tensor(empty), Tensor(empty.clone()))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        if (key is query and value is query and cache is None
                and self.kdim == self.embed_dim
                and self.vdim == self.embed_dim
                and self._plain_projections()):
            w = ops.concat([self.q_proj.weight, self.k_proj.weight,
                            self.v_proj.weight], axis=1)
            b = None
            if self.q_proj.bias is not None:
                b = ops.concat([self.q_proj.bias, self.k_proj.bias,
                                self.v_proj.bias], axis=0)
            q, k, v = (self._reshape_heads(t) for t in
                       ops.split(F.linear(query, w, b), 3, axis=-1))
        else:
            q = self._reshape_heads(self.q_proj(query))
            if isinstance(cache, self.StaticCache):
                k, v = cache.k, cache.v
            else:
                k = self._reshape_heads(self.k_proj(key))
                v = self._reshape_heads(self.v_proj(value))
                if isinstance(cache, self.Cache):
                    k = ops.concat([cache.k, k], axis=1)
                    v = ops.concat([cache.v, v], axis=1)
                    cache = self.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=_convert_attention_mask(attn_mask),
            dropout_p=self.dropout, training=self.training)
        b, s = out.shape[0], out.shape[1]
        out = self.out_proj(ops.reshape(out, [b, s, self.embed_dim]))
        if isinstance(cache, self.Cache):
            return (out, None, cache) if self.need_weights else (out, cache)
        return (out, None) if self.need_weights else out


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    """``num_layers`` deep copies of ``encoder_layer`` (the first is the
    layer itself), then an optional norm."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer] + [copy.deepcopy(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, new_cache = mod(output, src_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    """Self-attention, cross-attention over the memory and the
    feed-forward block, each with its residual, dropout and norm (before
    or after, ``normalize_before``)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.norm3 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
            incremental_cache = None
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                    cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
            static_cache = None
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask, cache[1])
            static_cache = cache[1]
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental_cache,
                                                static_cache))

    def gen_cache(self, memory):
        """(an empty self-attention ``Cache``, the memory's
        ``StaticCache``)."""
        incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(memory, memory,
                                           MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(Layer):
    """``num_layers`` deep copies of ``decoder_layer``, then an optional
    norm; with ``cache`` (``gen_cache``) it also returns the new caches."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer] + [copy.deepcopy(decoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask,
                                        memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        """One (Cache, StaticCache) a layer; ``do_zip`` regroups them as
        (all Caches, all StaticCaches)."""
        cache = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            cache = list(zip(*cache))
        return cache


class Transformer(Layer):
    """The encoder-decoder of Vaswani et al.: ``num_encoder_layers`` and
    ``num_decoder_layers`` layers (final norms only with
    ``normalize_before``), or the custom stacks given."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            enc_norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            dec_norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length):
        """[length, length] fp32 additive causal mask (0 on and below the
        diagonal, -1e30 above), on the current device."""
        keep = torch.ones((length, length), dtype=torch.bool,
                          device=current_device()).tril()
        return Tensor(torch.zeros(keep.shape, device=keep.device)
                      .masked_fill(~keep, -1e30))
