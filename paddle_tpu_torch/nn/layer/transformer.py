"""Transformer layers (counterpart of ``paddle_tpu/nn/layer/transformer.py``):
``MultiHeadAttention`` without its caches, ``TransformerEncoderLayer``
and ``TransformerEncoder``. The decoder, ``Transformer`` and the
attention caches are still to port.

Attention goes through the Paddle-API ``F.scaled_dot_product_attention``:
with no mask and no active dropout that is the flash kernels (K1
forward, K2/K3 backward) on a CUDA tensor, non-causal.
"""
from __future__ import annotations

import copy

import torch

from ... import ops
from ...core import dispatch
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
    nn/layer/transformer.py MultiHeadAttention). Self-attention runs one
    (E, 3E) projection, the three weights concatenated, as the JAX
    package does, while the three are plain ``Linear``s."""

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

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        if cache is not None:
            raise NotImplementedError(
                "later slice: MultiHeadAttention caches")
        key = query if key is None else key
        value = key if value is None else value
        if (key is query and value is query
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
            k = self._reshape_heads(self.k_proj(key))
            v = self._reshape_heads(self.v_proj(value))
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=_convert_attention_mask(attn_mask),
            dropout_p=self.dropout, training=self.training)
        b, s = out.shape[0], out.shape[1]
        out = self.out_proj(ops.reshape(out, [b, s, self.embed_dim]))
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
        if cache is not None:
            raise NotImplementedError(
                "later slice: MultiHeadAttention caches")
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, src, src, src_mask)
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
        return src


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
        if cache is not None:
            raise NotImplementedError(
                "later slice: MultiHeadAttention caches")
        output = src
        for mod in self.layers:
            output = mod(output, src_mask)
        if self.norm is not None:
            output = self.norm(output)
        return output
