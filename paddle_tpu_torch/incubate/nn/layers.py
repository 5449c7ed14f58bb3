"""The fused transformer layers (counterpart of
``paddle_tpu/incubate/nn/layers.py``): Paddle's module contracts (the
same parameters, residual and norm order, ``normalize_before``) over the
port's layers. ``FusedMultiHeadAttention`` without a mask is
``F.flash_attention``: with no active dropout, K1 on a CUDA tensor (K2/K3
in its backward); a mask takes ``F.scaled_dot_product_attention``.
"""
from __future__ import annotations

from ... import nn, ops
from ...nn import functional as F

__all__ = [
    "FusedLinear", "FusedDropoutAdd", "FusedBiasDropoutResidualLayerNorm",
    "FusedMultiHeadAttention", "FusedFeedForward",
    "FusedTransformerEncoderLayer",
]


class FusedLinear(nn.Layer):
    """GEMM + bias epilogue (reference fused_linear.py FusedLinear)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None):
        super().__init__()
        self.transpose_weight = transpose_weight
        if transpose_weight:
            # weight stored (out, in); bias is ALWAYS (out,)
            self.weight = self.create_parameter(
                (out_features, in_features), attr=weight_attr)
            self.bias = (None if bias_attr is False else
                         self.create_parameter((out_features,),
                                               attr=bias_attr, is_bias=True))
            self.linear = None
        else:
            self.linear = nn.Linear(in_features, out_features,
                                    weight_attr=weight_attr,
                                    bias_attr=bias_attr)
            self.weight = self.linear.weight
            self.bias = self.linear.bias

    def forward(self, x):
        if self.transpose_weight:
            out = x @ self.weight.t()
            if self.bias is not None:
                out = out + self.bias
            return out
        return self.linear(x)


class FusedDropoutAdd(nn.Layer):
    """dropout(x) + y in one fusion (reference fused_dropout_add.py)."""

    def __init__(self, p=0.5, mode="upscale_in_train", name=None):
        super().__init__()
        self.dropout = nn.Dropout(p, mode=mode)

    def forward(self, x, y):
        return self.dropout(x) + y


class FusedBiasDropoutResidualLayerNorm(nn.Layer):
    """LN(residual + dropout(x + bias)) (reference
    fused_transformer.py:83)."""

    def __init__(self, embed_dim, dropout_rate=0.5, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.linear_bias = self.create_parameter((embed_dim,), is_bias=True)
        self.dropout = nn.Dropout(dropout_rate)
        self.norm = nn.LayerNorm(embed_dim, epsilon=epsilon)

    def forward(self, x, residual):
        return self.norm(residual + self.dropout(x + self.linear_bias))


class FusedMultiHeadAttention(nn.Layer):
    """Pre/post-LN multi-head self-attention block with residual
    (reference fused_transformer.py:189); the attention core is flash
    attention."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None):
        super().__init__()
        if need_weights:
            raise NotImplementedError(
                "need_weights=True is unsupported (flash attention does "
                "not materialize probabilities)")
        if nranks > 1 or ring_id >= 0:
            raise NotImplementedError(
                "tensor-parallel FusedMultiHeadAttention: use "
                "fleet.ColumnParallelLinear/RowParallelLinear layers (the "
                "mp mesh axis), not nranks/ring_id")
        if (kdim not in (None, embed_dim)) or (vdim not in (None,
                                                            embed_dim)):
            raise NotImplementedError(
                "cross-attention kdim/vdim != embed_dim is unsupported "
                "in the fused layer; use nn.MultiHeadAttention")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.normalize_before = normalize_before
        self.qkv = nn.Linear(embed_dim, 3 * embed_dim,
                             weight_attr=qkv_weight_attr,
                             bias_attr=qkv_bias_attr)
        self.out_proj = nn.Linear(embed_dim, embed_dim,
                                  weight_attr=linear_weight_attr,
                                  bias_attr=linear_bias_attr)
        self.attn_dropout_rate = attn_dropout_rate
        self.dropout = nn.Dropout(dropout_rate)
        norm_w = pre_ln_scale_attr if normalize_before else ln_scale_attr
        norm_b = pre_ln_bias_attr if normalize_before else ln_bias_attr
        self.norm = nn.LayerNorm(embed_dim, epsilon=epsilon,
                                 weight_attr=norm_w, bias_attr=norm_b)

    def forward(self, x, attn_mask=None):
        residual = x
        if self.normalize_before:
            x = self.norm(x)
        b, s, _ = x.shape
        qkv = ops.reshape(self.qkv(x), [b, s, 3, self.num_heads,
                                        self.head_dim])
        q, k, v = ops.unbind(qkv, axis=2)
        if attn_mask is not None:
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask,
                dropout_p=self.attn_dropout_rate if self.training else 0.0,
                training=self.training)
        else:
            out, _ = F.flash_attention(
                q, k, v,
                dropout=self.attn_dropout_rate if self.training else 0.0,
                causal=False, training=self.training)
        out = self.out_proj(ops.reshape(out, [b, s, self.embed_dim]))
        out = residual + self.dropout(out)
        if not self.normalize_before:
            out = self.norm(out)
        return out


class FusedFeedForward(nn.Layer):
    """Pre/post-LN MLP block with residual (reference
    fused_transformer.py:483)."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None,
                 ln2_bias_attr=None, nranks=1, ring_id=-1, name=None):
        super().__init__()
        if nranks > 1 or ring_id >= 0:
            raise NotImplementedError(
                "tensor-parallel FusedFeedForward: use the fleet mp "
                "layers, not nranks/ring_id")
        self.normalize_before = normalize_before
        self.linear1 = nn.Linear(d_model, dim_feedforward,
                                 weight_attr=linear1_weight_attr,
                                 bias_attr=linear1_bias_attr)
        self.linear2 = nn.Linear(dim_feedforward, d_model,
                                 weight_attr=linear2_weight_attr,
                                 bias_attr=linear2_bias_attr)
        self.act = {"relu": F.relu, "gelu": F.gelu}[activation]
        act_dropout_rate = (dropout_rate if act_dropout_rate is None
                            else act_dropout_rate)
        self.act_dropout = nn.Dropout(act_dropout_rate)
        self.dropout = nn.Dropout(dropout_rate)
        norm_w = ln1_scale_attr if normalize_before else ln2_scale_attr
        norm_b = ln1_bias_attr if normalize_before else ln2_bias_attr
        self.norm = nn.LayerNorm(d_model, epsilon=epsilon,
                                 weight_attr=norm_w, bias_attr=norm_b)

    def forward(self, x):
        residual = x
        if self.normalize_before:
            x = self.norm(x)
        x = self.linear2(self.act_dropout(self.act(self.linear1(x))))
        out = residual + self.dropout(x)
        if not self.normalize_before:
            out = self.norm(out)
        return out


class FusedTransformerEncoderLayer(nn.Layer):
    """FusedMultiHeadAttention + FusedFeedForward (reference
    fused_transformer.py:697)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout_rate = (dropout_rate if attn_dropout_rate is None
                             else attn_dropout_rate)
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=attn_dropout_rate,
            normalize_before=normalize_before,
            qkv_weight_attr=weight_attr, qkv_bias_attr=bias_attr,
            linear_weight_attr=weight_attr, linear_bias_attr=bias_attr)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before,
            linear1_weight_attr=weight_attr, linear1_bias_attr=bias_attr,
            linear2_weight_attr=weight_attr, linear2_bias_attr=bias_attr)

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            raise NotImplementedError(
                "incremental-decode cache is not supported here; use "
                "nn.functional.block_multihead_attention for cached "
                "serving")
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))
