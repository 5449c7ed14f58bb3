"""The rest of the functional surface (counterpart of
``paddle_tpu/nn/functional/tail.py``): distances and losses, the
block-sparse and packed attentions, and the in-place activations.

The losses reduce in an op of their own after the elementwise op, as
the JAX package does (``ops.mean``/``ops.sum``). The in-place
activations put the activation's payload, with its autograd history,
into the input Tensor."""
from __future__ import annotations

import math

import torch

from ... import ops
from ._op import call

__all__ = [
    "pairwise_distance", "dice_loss", "npair_loss", "poisson_nll_loss",
    "multi_label_soft_margin_loss", "soft_margin_loss",
    "multi_margin_loss", "gaussian_nll_loss",
    "triplet_margin_with_distance_loss", "adaptive_log_softmax_with_loss",
    "margin_cross_entropy", "sparse_attention", "flash_attn_qkvpacked",
    "flash_attn_varlen_qkvpacked", "elu_", "hardtanh_", "leaky_relu_",
    "relu_", "softmax_", "tanh_", "thresholded_relu_",
]


def _reduce(loss, reduction):
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(
            f"reduction should be 'mean'/'sum'/'none', got {reduction!r}")
    if reduction == "none":
        return loss
    if isinstance(loss, torch.Tensor):
        return loss.mean() if reduction == "mean" else loss.sum()
    return ops.mean(loss) if reduction == "mean" else ops.sum(loss)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """||x - y + epsilon||_p over the last dim."""
    def body(a, b):
        out = ((a - b + epsilon).abs() ** p).sum(-1) ** (1.0 / p)
        return out[..., None] if keepdim else out
    return call("pairwise_distance", body, [x, y])


def dice_loss(input, label, epsilon=1e-5, name=None):
    """1 - 2 |X n Y| / (|X| + |Y|) of softmaxed ``input`` against the
    one-hot of ``label`` (..., 1), averaged over the batch."""
    def body(a, lb):
        one_hot = torch.nn.functional.one_hot(
            lb.squeeze(-1).long(), a.shape[-1]).to(a.dtype)
        dims = tuple(range(1, a.dim()))
        inse = (a * one_hot).sum(dims)
        denom = a.sum(dims) + one_hot.sum(dims)
        return (1 - 2 * inse / (denom + epsilon)).mean()
    return call("dice_loss", body, [input, label], mask=[True, False])


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    """The n-pair loss: softmax cross entropy of anchor-positive
    similarities against the same-label targets, plus the L2 term."""
    def body(a, p, lb):
        n = a.shape[0]
        lb = lb.reshape(n, 1).float()
        same = (lb == lb.t()).float()
        same = same / same.sum(1, keepdim=True)
        l2 = ((a * a).sum(1).mean() + (p * p).sum(1).mean()) * 0.25 * l2_reg
        logp = torch.log_softmax(a @ p.t(), dim=-1)
        return l2 + (-(same * logp).sum(-1)).mean()
    return call("npair_loss", body, [anchor, positive, labels],
                mask=[True, True, False])


def poisson_nll_loss(input, label, log_input=True, full=False,
                     epsilon=1e-8, reduction="mean", name=None):
    """exp(x) - y x (``log_input``) or x - y log(x + eps), with Stirling's
    term where y > 1 when ``full``."""
    def body(a, y):
        loss = (torch.exp(a) - y * a if log_input
                else a - y * torch.log(a + epsilon))
        if full:
            stirling = y * torch.log(y) - y + 0.5 * torch.log(
                2 * math.pi * y)
            loss = loss + torch.where(y > 1, stirling,
                                      torch.zeros_like(stirling))
        return loss
    return _reduce(call("poisson_nll_loss", body, [input, label],
                        mask=[True, False]), reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    """Per-class BCE with logits averaged over the classes."""
    def body(a, y, *w):
        term = y * torch.nn.functional.logsigmoid(a) \
            + (1 - y) * torch.nn.functional.logsigmoid(-a)
        return -(term * w[0] if w else term).mean(-1)
    ins = [input, label] + ([weight] if weight is not None else [])
    return _reduce(call("multi_label_soft_margin_loss", body, ins,
                        mask=[True] + [False] * (len(ins) - 1)), reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):
    """log(1 + exp(-label * input))."""
    return _reduce(call("soft_margin_loss", lambda a, y: torch.log1p(
        torch.exp(-y.to(a.dtype) * a)), [input, label], mask=[True, False]),
        reduction)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    """The multi-class hinge: sum over the other classes of
    max(0, margin - x_y + x_i)^p (times the label's weight), over C."""
    def body(a, y, *w):
        c = a.shape[1]
        y = y.long()
        m = (margin - a.gather(1, y[:, None]) + a).clamp_min(0.0) ** p
        if w:
            m = m * w[0][y][:, None]
        mask = torch.nn.functional.one_hot(y, c).to(a.dtype)
        return ((1 - mask) * m).sum(-1) / c
    ins = [input, label] + ([weight] if weight is not None else [])
    return _reduce(call("multi_margin_loss", body, ins,
                        mask=[True] + [False] * (len(ins) - 1)), reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    """0.5 (log var + (x - y)^2 / var), var floored at epsilon."""
    def body(a, y, var):
        var = var.clamp_min(epsilon)
        loss = 0.5 * (torch.log(var) + (a - y) ** 2 / var)
        return loss + 0.5 * math.log(2 * math.pi) if full else loss
    return _reduce(call("gaussian_nll_loss", body, [input, label, variance],
                        mask=[True, False, True]), reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    """max(d(a, p) - d(a, n) + margin, 0) under ``distance_function``
    (default ``pairwise_distance``)."""
    dist = distance_function or pairwise_distance
    d_pos = dist(input, positive)
    d_neg = dist(input, negative)
    if swap:
        d_swap = dist(positive, negative)
        d_neg = (torch.minimum(d_neg, d_swap)
                 if isinstance(d_neg, torch.Tensor)
                 else ops.minimum(d_neg, d_swap))
    return _reduce(call("triplet_margin_with_distance_loss",
                        lambda dp, dn: (dp - dn + margin).clamp_min(0.0),
                        [d_pos, d_neg]), reduction)


def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights,
                                   cutoffs, head_bias=None, name=None):
    """The adaptive softmax (Grave et al.): the head scores the shortlist
    and one slot a tail cluster, each cluster a projected softmax. Returns
    (each sample's target log-probability, the mean NLL)."""
    n_tails = len(tail_weights)
    cutoffs = [int(c) for c in cutoffs]
    shortlist = cutoffs[0]

    def body(x, y, hw, *rest):
        tw = [(rest[2 * i], rest[2 * i + 1]) for i in range(n_tails)]
        head = x @ hw
        if len(rest) > 2 * n_tails:
            head = head + rest[2 * n_tails]
        head_logp = torch.log_softmax(head, dim=-1)
        y = y.long()
        out = head_logp.gather(1, y.clamp(0, shortlist - 1)[:, None])[:, 0]
        for i, (lo, hi) in enumerate(zip(cutoffs[:-1], cutoffs[1:])):
            cl_logp = torch.log_softmax((x @ tw[i][0]) @ tw[i][1], dim=-1)
            rel = (y - lo).clamp(0, hi - lo - 1)
            score = head_logp[:, shortlist + i] + cl_logp.gather(
                1, rel[:, None])[:, 0]
            out = torch.where((y >= lo) & (y < hi), score, out)
        return out, -out.mean()
    ins = [input, label, head_weight] + [w for pair in tail_weights
                                         for w in pair]
    if head_bias is not None:
        ins.append(head_bias)
    return call("adaptive_log_softmax_with_loss", body, ins,
                mask=[True, False] + [True] * (len(ins) - 2))


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    """ArcFace-family loss on cosines: the target's becomes
    cos(m1 theta + m2) - m3, everything times ``scale``, then softmax
    cross entropy (one group)."""
    def body(cos, y):
        c = cos.shape[1]
        y = y.long()
        theta = torch.arccos(cos.clamp(-1.0 + 1e-7, 1.0 - 1e-7))
        target = torch.cos(margin1 * theta + margin2) - margin3
        hot = torch.nn.functional.one_hot(y, c) > 0
        logp = torch.log_softmax(torch.where(hot, target, cos) * scale,
                                 dim=-1)
        return -logp.gather(1, y[:, None])[:, 0], torch.exp(logp)
    loss, softmax = call("margin_cross_entropy", body, [logits, label],
                         mask=[True, False])
    loss = _reduce(loss, reduction) if reduction else loss
    return (loss, softmax) if return_softmax else loss


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention of [B, H, S, D] q/k/v restricted to the CSR pattern (each
    row's columns), as dense attention under that mask."""
    def body(q, k, v, off, cols):
        b, h, s, d = q.shape
        scores = torch.einsum("bhsd,bhtd->bhst", q, k) / math.sqrt(d)
        width = cols.shape[-1] // s
        cols2 = cols.reshape(b, h, s, width).long()
        mask = torch.zeros((b, h, s, s), dtype=torch.bool, device=q.device)
        mask.scatter_(-1, cols2, True)
        scores = scores.masked_fill(~mask, -1e30)
        probs = torch.softmax(scores, dim=-1).masked_fill(~mask, 0.0)
        return torch.einsum("bhst,bhtd->bhsd", probs, v)
    return call("sparse_attention", body, [query, key, value,
                                           sparse_csr_offset,
                                           sparse_csr_columns],
                mask=[True, True, True, False, False])


def _unpack(qkv, axis):
    if isinstance(qkv, torch.Tensor):
        return qkv.unbind(axis)
    return ops.unbind(qkv, axis=axis)


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False,
                         return_softmax=False, *, training=True, name=None):
    """``flash_attention`` of a packed [B, S, 3, H, D] qkv."""
    from .flash_attention import flash_attention
    q, k, v = _unpack(qkv, 2)
    return flash_attention(q, k, v, dropout=dropout, causal=causal,
                           return_softmax=return_softmax, training=training)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q, max_seqlen_k, scale,
                                dropout=0.0, causal=False,
                                return_softmax=False, *, training=True,
                                name=None):
    """``flash_attn_unpadded`` of a packed [total, 3, H, D] qkv."""
    from .flash_attention import flash_attn_unpadded
    q, k, v = _unpack(qkv, 1)
    return flash_attn_unpadded(q, k, v, cu_seqlens_q, cu_seqlens_k,
                               max_seqlen_q, max_seqlen_k, scale,
                               dropout=dropout, causal=causal,
                               return_softmax=return_softmax,
                               training=training)


def _act_inplace(name):
    def fn(x, *args, **kwargs):
        from .. import functional as F
        out = getattr(F, name[:-1])(x, *args, **kwargs)
        return x._swap_payload(out._data)
    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = (f"In place ``nn.functional.{name[:-1]}``: the Tensor takes "
                  f"the result's payload and its autograd history.")
    return fn


elu_ = _act_inplace("elu_")
hardtanh_ = _act_inplace("hardtanh_")
leaky_relu_ = _act_inplace("leaky_relu_")
relu_ = _act_inplace("relu_")
softmax_ = _act_inplace("softmax_")
tanh_ = _act_inplace("tanh_")
thresholded_relu_ = _act_inplace("thresholded_relu_")
