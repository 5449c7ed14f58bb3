"""The losses (counterpart of ``paddle_tpu/nn/functional/loss.py``):
cross entropy and the fused chunked LM-head loss, and the rest through
``_op.call`` with the JAX package's formulas, reductions ("none", "sum",
any other name the mean) and conventions: CTC log-softmaxes its (T, N,
C) logits in fp32 and its "mean" averages each loss over its label
length; RNN-T builds the alpha lattice a label row at a time;
``edit_distance`` drops the ignored tokens and normalizes by the label
length; ``ctc_align`` works on the host, as there, since its width
depends on the data.

Hard labels with softmax, as the JAX package's streaming formulation
computes them: nll = lse - logits[label] with the max taken out in the
input dtype and the sums in fp32, ``ignore_index``, ``label_smoothing``
and the three reductions; soft labels, class weights and
``use_softmax=False`` through an fp32 log-probability, as there. ``cross_entropy`` is on amp's
black list (its logits go to fp32), ``fused_linear_cross_entropy`` on
the white list (x and the weight go to the amp dtype; the LSE stays
fp32).

On Paddle ``Tensor``s each is one op through ``core.dispatch.call`` (the
labels take no gradient) with the same math and the same layouts; on
``torch.Tensor``s, the torch-level function.
"""
from __future__ import annotations


import numpy as np
import torch

from ...amp.state import amp_cast
from ...core import dispatch
from ...core.tensor import Tensor, _payload, as_tensor
from ._op import call


def cross_entropy(input, label, weight=None, ignore_index: int = -100,
                  reduction: str = "mean", soft_label: bool = False,
                  axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0, name=None):
    """Cross entropy of ``input`` (classes on ``axis``) against ``label``.

    Hard labels are integers (the input's shape without ``axis``, or with
    a size-1 ``axis``); soft labels are class distributions of the
    input's shape (``soft_label=True``, or a float label of that shape).
    ``input`` holds logits, or probabilities with ``use_softmax=False``
    (then log(clip(p, 1e-15, 1))). ``weight`` (one a class) scales each
    hard label's loss, and "mean" divides by the weights' sum over the
    labels not ignored; a soft label's loss is scaled by its expected
    weight. Returns fp32."""
    if isinstance(input, Tensor):
        inputs = [input, as_tensor(label)]
        if weight is not None:
            inputs.append(as_tensor(weight))
        return dispatch.call(
            "cross_entropy", lambda a, lab, *w: cross_entropy(
                a, lab, w[0] if w else None, ignore_index, reduction,
                soft_label, axis, use_softmax, label_smoothing),
            inputs, differentiable_mask=[True, bool(soft_label)]
            + [False] * (weight is not None))
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    (input,) = amp_cast("cross_entropy", input)
    ax = axis % input.dim()
    c = input.shape[ax]
    hard = not (soft_label or (label.dim() == input.dim()
                               and label.shape[ax] == c
                               and label.is_floating_point()))
    if use_softmax and hard:
        # the max leaves autograd (the JAX package's stop_gradient); the
        # shift runs in the input dtype, the sums in fp32
        m = input.detach().amax(dim=ax, keepdim=True)
        shifted = (input - m).float()
        lse = torch.log(torch.exp(shifted).sum(dim=ax)) \
            + m.squeeze(ax).float()
        lab, valid, safe = _hard_labels(label, input, ax, ignore_index)
        picked = input.gather(ax, safe.unsqueeze(ax)).squeeze(ax).float()
        nll = lse - picked
        if label_smoothing > 0:
            smooth = lse - input.float().mean(dim=ax)
            nll = (1 - label_smoothing) * nll + label_smoothing * smooth
        return _hard_label_reduce(nll, valid, reduction, weight, safe)
    if use_softmax:
        logp = torch.log_softmax(input.float(), dim=ax)
    else:
        logp = torch.log(torch.clamp(input.float(), 1e-15, 1.0))
    if not hard:
        soft = label.float()
        if label_smoothing > 0:
            soft = soft * (1 - label_smoothing) + label_smoothing / c
        loss = -(soft * logp).sum(dim=ax)
        if weight is not None:
            shape = [1] * input.dim()
            shape[ax] = c
            loss = loss * (soft * weight.float().reshape(shape)).sum(dim=ax)
        if reduction == "mean":
            return loss.mean()
        return loss.sum() if reduction == "sum" else loss
    lab, valid, safe = _hard_labels(label, input, ax, ignore_index)
    nll = -logp.gather(ax, safe.unsqueeze(ax)).squeeze(ax)
    if label_smoothing > 0:
        nll = (1 - label_smoothing) * nll \
            + label_smoothing * -logp.mean(dim=ax)
    return _hard_label_reduce(nll, valid, reduction, weight, safe)


def _hard_labels(label, input, ax, ignore_index):
    """(labels without a size-1 class axis, the mask of those not
    ignored, the labels with the ignored ones at class 0)."""
    lab = label.long()
    if lab.dim() == input.dim() and lab.shape[ax] == 1:
        lab = lab.squeeze(ax)
    valid = lab != ignore_index
    return lab, valid, torch.where(valid, lab, torch.zeros_like(lab))


def _hard_label_reduce(nll: torch.Tensor, valid: torch.Tensor,
                       reduction: str, weight=None,
                       safe=None) -> torch.Tensor:
    """The ignore_index and class-weight epilogue: ignored positions give
    0; "mean" divides by the number of the others (at least 1), or with
    ``weight`` by their weights' sum (at least 1e-12)."""
    zero = torch.zeros((), dtype=nll.dtype, device=nll.device)
    if weight is not None:
        wv = weight.float()[safe]
        nll = torch.where(valid, nll * wv, zero)
        if reduction == "mean":
            return nll.sum() / torch.where(valid, wv, zero).sum().clamp_min(
                1e-12)
    else:
        nll = torch.where(valid, nll, zero)
        if reduction == "mean":
            return nll.sum() / valid.sum().clamp_min(1)
    if reduction == "sum":
        return nll.sum()
    return nll


def _chunk_logits(x, weight, bias, transpose_y):
    logits = torch.matmul(x, weight.t() if transpose_y else weight)
    return logits if bias is None else logits + bias


class _LinearCrossEntropy(torch.autograd.Function):
    """Per-row nll of ``x W (+ b)`` against ``label``, ``chunk`` rows at a
    time. The forward keeps each row's fp32 LSE and no logits; the
    backward recomputes each chunk's logits and takes its gradient,
    (softmax - onehot) scaled by the row's incoming gradient, in x's
    dtype for the two products (the weight's and bias's sums over the
    chunks in fp32)."""

    @staticmethod
    def forward(ctx, x, weight, bias, label, transpose_y, ignore_index,
                chunk):
        n = x.shape[0]
        nll = torch.zeros(n, dtype=torch.float32, device=x.device)
        lse = torch.zeros(n, dtype=torch.float32, device=x.device)
        for s in range(0, n, chunk):
            logits = _chunk_logits(x[s:s + chunk], weight, bias, transpose_y)
            lab = label[s:s + chunk]
            # the max in the logits' dtype, the shift rounded there, the
            # sums in fp32, as the JAX chunk computes them
            m = logits.amax(dim=-1, keepdim=True)
            shifted = (logits - m).float()
            row_lse = torch.log(torch.exp(shifted).sum(dim=-1)) \
                + m.squeeze(-1).float()
            valid = lab != ignore_index
            safe = torch.where(valid, lab, torch.zeros_like(lab))
            picked = logits.gather(-1, safe[:, None]).squeeze(-1).float()
            nll[s:s + chunk] = torch.where(valid, row_lse - picked,
                                           torch.zeros_like(row_lse))
            lse[s:s + chunk] = row_lse
        ctx.save_for_backward(x, weight, bias, label, lse)
        ctx.attrs = (transpose_y, ignore_index, chunk)
        return nll

    @staticmethod
    def backward(ctx, grad):
        x, weight, bias, label, lse = ctx.saved_tensors
        transpose_y, ignore_index, chunk = ctx.attrs
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = torch.zeros_like(x) if need_x else None
        dw = torch.zeros(weight.shape, dtype=torch.float32,
                         device=weight.device) if need_w else None
        db = torch.zeros(bias.shape, dtype=torch.float32,
                         device=bias.device) if need_b else None
        for s in range(0, x.shape[0], chunk):
            xc = x[s:s + chunk]
            logits = _chunk_logits(xc, weight, bias, transpose_y)
            lab = label[s:s + chunk]
            valid = lab != ignore_index
            safe = torch.where(valid, lab, torch.zeros_like(lab))
            p = torch.exp(logits.float() - lse[s:s + chunk, None])
            p.scatter_add_(1, safe[:, None], -valid.float()[:, None])
            coef = torch.where(valid, grad[s:s + chunk].float(),
                               torch.zeros_like(p[:, 0]))
            d = (p * coef[:, None]).to(x.dtype)
            if need_x:
                dx[s:s + chunk] = torch.matmul(
                    d, weight if transpose_y else weight.t())
            if need_w:
                dw += (torch.matmul(d.t(), xc) if transpose_y
                       else torch.matmul(xc.t(), d))
            if need_b:
                db += d.sum(dim=0)
        return (dx, None if dw is None else dw.to(weight.dtype),
                None if db is None else db.to(bias.dtype),
                None, None, None, None)


def fused_linear_cross_entropy(x, weight, label, bias=None,
                               transpose_y: bool = False,
                               ignore_index: int = -100,
                               reduction: str = "mean",
                               chunk_rows: int = 4096):
    """Cross entropy of ``x @ weight (+ bias)`` against hard ``label``
    without the full ``(N, V)`` logits: ``chunk_rows`` rows at a time,
    each chunk's logits recomputed in the backward, so the peak is about
    ``chunk_rows * V``. ``x`` is (N, H); ``weight`` (H, V), or (V, H)
    with ``transpose_y`` (a tied embedding, or an ``nn.Linear`` weight);
    ``label`` (N,). The JAX package pads the last chunk with
    ``ignore_index`` rows for its scan; here it is shorter, which gives
    the same sums. ``reduction`` "mean" averages over the rows not
    ignored. The matmul runs in the input dtype, the max and LSE in
    fp32; the result is fp32."""
    if isinstance(x, Tensor):
        ins = [x, weight, as_tensor(label)] + ([bias] if bias is not None
                                               else [])
        return dispatch.call(
            "fused_linear_cross_entropy",
            lambda a, w, lab, *b: fused_linear_cross_entropy(
                a, w, lab, *b, transpose_y=transpose_y,
                ignore_index=ignore_index, reduction=reduction,
                chunk_rows=chunk_rows), ins,
            differentiable_mask=[True, True, False, True])
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"fused_linear_cross_entropy: unknown reduction "
                         f"{reduction!r}")
    x, weight, bias = amp_cast("fused_linear_cross_entropy", x, weight, bias)
    label = label.long()
    nll = _LinearCrossEntropy.apply(x, weight, bias, label, transpose_y,
                                    ignore_index, max(int(chunk_rows), 1))
    return _hard_label_reduce(nll, label != ignore_index, reduction)


def _reduce(val, reduction):
    """"none", "sum", or (any other name, as in the JAX package) the
    mean."""
    if reduction == "none":
        return val
    return val.sum() if reduction == "sum" else val.mean()


def _weights(*ts):
    return [t for t in ts if t is not None]


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """Unreduced cross entropy with the class axis kept (size 1); with
    ``return_softmax`` also the softmax of the logits."""
    from .activation import softmax
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    loss = call("unsqueeze", lambda a: a.unsqueeze(axis), [loss])
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """-logp[label] over classes on axis 1, the ignored labels giving 0;
    "mean" divides by the (weighted) count of the others."""
    def body(logp, lab, *w):
        lab = lab.long()
        valid = lab != ignore_index
        safe = torch.where(valid, lab, torch.zeros_like(lab))
        nll = -logp.gather(1, safe.unsqueeze(1)).squeeze(1)
        wv = w[0][safe] if w else torch.ones_like(nll)
        zero = torch.zeros((), dtype=nll.dtype, device=nll.device)
        nll = torch.where(valid, nll * wv, zero)
        if reduction == "mean":
            return nll.sum() / torch.where(valid, wv, zero).sum().clamp_min(
                1e-12)
        return _reduce(nll, reduction)
    return call("nll_loss", body, _weights(input, label, weight),
                mask=[True, False, False][:2 + (weight is not None)])


def mse_loss(input, label, reduction="mean", name=None):
    """(input - label)^2, reduced."""
    return call("mse_loss", lambda a, b: _reduce((a - b.to(a.dtype)) ** 2,
                                                 reduction), [input, label])


def l1_loss(input, label, reduction="mean", name=None):
    """|input - label|, reduced."""
    return call("l1_loss", lambda a, b: _reduce((a - b.to(a.dtype)).abs(),
                                                reduction), [input, label])


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    """0.5 d^2 / delta below delta, |d| - 0.5 delta above."""
    def body(a, b):
        d = a - b.to(a.dtype)
        ad = d.abs()
        return _reduce(torch.where(ad < delta, 0.5 * d * d / delta,
                                   ad - 0.5 * delta), reduction)
    return call("smooth_l1_loss", body, [input, label])


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    """-(y log p + (1 - y) log(1 - p)), p clipped to [1e-12, 1 - 1e-7]."""
    def body(p, y, *w):
        p = p.clamp(1e-12, 1 - 1e-7)
        val = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
        return _reduce(val * w[0] if w else val, reduction)
    return call("binary_cross_entropy", body, _weights(input, label, weight),
                mask=[True, True, False][:2 + (weight is not None)])


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """BCE from logits, stably: (1 - y) x + lw (log(e^-m + e^(-x-m)) + m),
    m = max(-x, 0), lw = (pos_weight - 1) y + 1."""
    has_w, has_pw = weight is not None, pos_weight is not None

    def body(x, y, *rest):
        y = y.to(x.dtype)
        m = (-x).clamp_min(0)
        soft = torch.log(torch.exp(-m) + torch.exp(-x - m))
        if has_pw:
            loss = (1 - y) * x + ((rest[-1] - 1) * y + 1) * (soft + m)
        else:
            loss = (1 - y) * x + m + soft
        return _reduce(loss * rest[0] if has_w else loss, reduction)
    return call("bce_with_logits", body,
                _weights(logit, label, weight, pos_weight),
                mask=[True, True] + [False] * (has_w + has_pw))


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    """target * (log target - input) over log-probabilities ``input``
    ("batchmean" divides the sum by the batch)."""
    def body(lp, t):
        if log_target:
            val = torch.exp(t) * (t - lp)
        else:
            val = t * (torch.log(t.clamp_min(1e-12)) - lp)
            val = torch.where(t > 0, val, torch.zeros_like(val))
        if reduction == "batchmean":
            return val.sum() / lp.shape[0]
        return _reduce(val, reduction)
    return call("kl_div", body, [input, label])


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    """max(0, -label (input - other) + margin)."""
    return call("margin_ranking_loss", lambda a, b, y: _reduce(
        (-y * (a - b) + margin).clamp_min(0.0), reduction),
        [input, other, label], mask=[True, True, False])


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    """input where label is 1, else max(0, margin - input)."""
    return call("hinge_embedding_loss", lambda a, y: _reduce(torch.where(
        y == 1, a, (margin - a).clamp_min(0.0)), reduction), [input, label],
        mask=[True, False])


def _cos_last(a, b, eps):
    return (a * b).sum(-1) / (torch.linalg.vector_norm(a, dim=-1)
                              * torch.linalg.vector_norm(b, dim=-1)
                              ).clamp_min(eps)


def cosine_embedding_loss(input1, input2, label, margin=0.0, reduction="mean",
                          name=None):
    """1 - cos for label 1, max(0, cos - margin) otherwise."""
    def body(a, b, y):
        cos = _cos_last(a, b, 1e-12)
        return _reduce(torch.where(y == 1, 1 - cos,
                                   (cos - margin).clamp_min(0.0)), reduction)
    return call("cosine_embedding_loss", body, [input1, input2, label],
                mask=[True, True, False])


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    """max(0, d(a, p) - d(a, n) + margin), d = ||u - v + epsilon||_p."""
    def body(a, pos, neg):
        def dist(u, v):
            return ((u - v + epsilon).abs() ** p).sum(-1) ** (1.0 / p)
        d_an = dist(a, neg)
        if swap:
            d_an = torch.minimum(d_an, dist(pos, neg))
        return _reduce((dist(a, pos) - d_an + margin).clamp_min(0.0),
                       reduction)
    return call("triplet_margin_loss", body, [input, positive, negative])


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    """Focal-modulated BCE with logits, over ``normalizer`` if given."""
    def body(x, y, *n):
        p = torch.sigmoid(x)
        ce = x.clamp_min(0) - x * y + torch.log1p(torch.exp(-x.abs()))
        p_t = p * y + (1 - p) * (1 - y)
        a_t = alpha * y + (1 - alpha) * (1 - y)
        loss = a_t * ((1 - p_t) ** gamma) * ce
        return _reduce(loss / n[0] if n else loss, reduction)
    return call("sigmoid_focal_loss", body,
                _weights(logit, label, normalizer),
                mask=[True, False, False][:2 + (normalizer is not None)])


def square_error_cost(input, label):
    """(input - label)^2, unreduced."""
    return call("square_error_cost", lambda a, b: (a - b) ** 2,
                [input, label])


def log_loss(input, label, epsilon=1e-4, name=None):
    """-y log(p + eps) - (1 - y) log(1 - p + eps)."""
    return call("log_loss", lambda p, y: -y * torch.log(p + epsilon)
                - (1 - y) * torch.log(1 - p + epsilon), [input, label])


def huber_loss(input, label, delta=1.0, reduction="mean", name=None):
    """0.5 d^2 below delta, delta (|d| - 0.5 delta) above (not divided by
    delta, unlike smooth_l1_loss)."""
    def body(a, b):
        d = a - b
        ad = d.abs()
        return _reduce(torch.where(ad < delta, 0.5 * d * d,
                                   delta * (ad - 0.5 * delta)), reduction)
    return call("huber_loss", body, [input, label])


NEG = -1e30


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC by the forward algorithm in log space over (T, N, C) logits
    (log-softmaxed here in fp32), labels (N, S). "mean" is the mean of
    each loss over its label length, as in the JAX package."""
    def body(logits, lab, in_len, lab_len):
        t_max, n, _ = logits.shape
        logp = torch.log_softmax(logits.float(), dim=-1)
        s = lab.shape[1]
        ext_len = 2 * s + 1
        ext = torch.full((n, ext_len), blank, dtype=torch.long,
                         device=logits.device)
        ext[:, 1::2] = lab.long()
        neg = torch.full((n, ext_len), NEG, device=logits.device)
        alpha = neg.clone()
        alpha[:, 0] = logp[0, :, blank]
        alpha[:, 1] = logp[0].gather(1, ext[:, 1:2])[:, 0]
        odd = torch.arange(ext_len, device=logits.device) % 2 == 1
        skip = torch.cat([torch.zeros((n, 2), dtype=torch.bool,
                                      device=logits.device),
                          ext[:, 2:] != ext[:, :-2]], dim=1) & odd[None, :]
        in_len = in_len.long()
        for t in range(1, t_max):
            s1 = torch.cat([neg[:, :1], alpha[:, :-1]], dim=1)
            s2 = torch.where(skip, torch.cat([neg[:, :2], alpha[:, :-2]],
                                             dim=1), neg)
            merged = torch.logaddexp(torch.logaddexp(alpha, s1), s2)
            new = merged + logp[t].gather(1, ext)
            alpha = torch.where((t < in_len)[:, None], new, alpha)
        last = 2 * lab_len.long()
        a_last = alpha.gather(1, last[:, None])[:, 0]
        a_prev = alpha.gather(1, (last - 1).clamp_min(0)[:, None])[:, 0]
        loss = -torch.logaddexp(a_last, a_prev)
        if norm_by_times:
            loss = loss / in_len.to(loss.dtype)
        if reduction == "mean":
            return (loss / lab_len.clamp_min(1).to(loss.dtype)).mean()
        return _reduce(loss, reduction)
    return call("ctc_loss", body, [log_probs, labels, input_lengths,
                                   label_lengths],
                mask=[True, False, False, False])


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over a complete binary tree of the classes
    (class c is leaf c + K - 1 of a heap with K - 1 inner nodes), or over
    ``path_table``/``path_code``: the sum of BCE-with-logits decisions on
    the path to the root, (B, 1)."""
    k = num_classes
    depth = max(int(np.ceil(np.log2(max(k, 2)))), 1)
    has_bias, has_table = bias is not None, path_table is not None

    def body(x, wt, lab, *rest):
        if has_table:
            nodes, codes = rest[-2].long(), rest[-1].float()
            valid = (nodes >= 0).float()
            nodes = nodes.clamp_min(0)
        else:
            i = lab.reshape(-1).long() + (k - 1)
            nd, cd, vd = [], [], []
            for _ in range(depth):
                parent = torch.div(i - 1, 2, rounding_mode="floor")
                live = i > 0
                nd.append(torch.where(live, parent, torch.zeros_like(i)))
                cd.append((live & (i == 2 * parent + 1)).float())
                vd.append(live.float())
                i = torch.where(live, parent, torch.zeros_like(i))
            nodes, codes, valid = (torch.stack(v, dim=1)
                                   for v in (nd, cd, vd))
        logits = torch.einsum("bdf,bf->bd", wt[nodes], x)
        if has_bias:
            logits = logits + rest[0].reshape(-1)[nodes]
        per = (logits.clamp_min(0) - logits * codes
               + torch.log1p(torch.exp(-logits.abs()))) * valid
        return per.sum(dim=1, keepdim=True)
    ins = [input, weight, label] + ([bias] if has_bias else []) \
        + ([path_table, path_code] if has_table else [])
    return call("hsigmoid_loss", body, ins,
                mask=[True, True, False] + [True] * has_bias
                + [False, False] * has_table)


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None, name=None):
    """Levenshtein distance of each row of ``input`` to its row of
    ``label`` (the ``ignored_tokens`` dropped first), over the label's
    length when ``normalized``: ((B, 1) fp32, (1,) int32 batch size).
    Each DP row is one step over the batch: dp[c] = c + prefix-min of
    (e[k] - k), as the JAX package computes it."""
    ign = tuple(sorted(set(ignored_tokens or ())))
    m_pad, n_pad = int(input.shape[1]), int(label.shape[1])
    has_il, has_ll = input_length is not None, label_length is not None

    def body(a, b, *rest):
        dev = a.device
        bsz = a.shape[0]
        il = rest[0].reshape(-1).long() if has_il else torch.full(
            (bsz,), m_pad, device=dev)
        ll = rest[-1].reshape(-1).long() if has_ll else torch.full(
            (bsz,), n_pad, device=dev)

        def compact(seq, length, width):
            keep = torch.arange(width, device=dev)[None, :] < length[:, None]
            for tok in ign:
                keep &= seq != tok
            order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
            packed = torch.where(keep.gather(1, order), seq.long().gather(
                1, order), torch.full_like(order, -1))
            return packed, keep.sum(dim=1)

        s1, m_eff = compact(a, il, m_pad)
        s2, n_eff = compact(b, ll, n_pad)
        cols = torch.arange(n_pad + 1, device=dev)
        dp = cols[None, :].expand(bsz, -1)
        rows = torch.arange(bsz, device=dev)
        best = torch.where(m_eff == 0, dp[rows, n_eff], torch.zeros_like(
            m_eff))
        for r in range(1, m_pad + 1):
            cost = (s1[:, r - 1:r] != s2).long()
            e = torch.minimum(dp[:, 1:] + 1, dp[:, :-1] + cost)
            g = torch.cat([torch.full((bsz, 1), r, device=dev), e], dim=1)
            dp = torch.cummin(g - cols, dim=1).values + cols
            best = torch.where(m_eff == r, dp[rows, n_eff], best)
        dist = best.float()
        if normalized:
            dist = dist / n_eff.clamp_min(1).float()
        return dist.reshape(-1, 1), torch.full((1,), bsz, dtype=torch.int32,
                                               device=dev)
    ins = [input, label] + ([input_length] if has_il else []) \
        + ([label_length] if has_ll else [])
    return call("edit_distance", body, ins, mask=[False] * len(ins))


def ctc_align(input, input_length=None, blank=0, padding_value=0, name=None):
    """Greedy CTC alignment of (B, T) ids: repeats merged, blanks dropped,
    rows padded with ``padding_value``; (ids, lengths int32). On the host:
    the output's width depends on the data."""
    if not isinstance(input, (Tensor, torch.Tensor)):
        input = as_tensor(input)
    a = _payload(input).cpu().numpy()
    il = (np.asarray(_payload(input_length).cpu()).ravel()
          if isinstance(input_length, (Tensor, torch.Tensor))
          else np.full(a.shape[0], a.shape[1], np.int64)
          if input_length is None else np.asarray(input_length).ravel())
    rows = []
    for i in range(a.shape[0]):
        prev, out = None, []
        for tok in a[i, :il[i]].tolist():
            if tok != prev and tok != blank:
                out.append(tok)
            prev = tok
        rows.append(out)
    width = max(max((len(r) for r in rows), default=0), 1)
    res = np.full((a.shape[0], width), padding_value, dtype=a.dtype)
    for i, r in enumerate(rows):
        res[i, :len(r)] = r
    dev = _payload(input).device
    ids = torch.from_numpy(res).to(dev)
    lens = torch.tensor([len(r) for r in rows], dtype=torch.int32,
                        device=dev)
    if isinstance(input, torch.Tensor):
        return ids, lens
    return Tensor(ids), Tensor(lens)


def rnnt_loss(logits, labels, logit_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean", name=None):
    """RNN-Transducer loss over (B, T, U + 1, V) logits and (B, U) labels:
    the alpha lattice one label row at a time, each row a scan over T.
    FastEmit scales the gradient through the emissions by (1 + lambda)
    and leaves the value as it is."""
    def body(lp, lab, tl, ul):
        bsz, t_max, u1, _ = lp.shape
        tl, ul = tl.reshape(-1).long(), ul.reshape(-1).long()
        logp = torch.log_softmax(lp, dim=-1)
        blank_lp = logp[..., blank]
        emit = logp[:, :, :u1 - 1, :].gather(
            -1, lab.long()[:, None, :, None].expand(-1, t_max, -1, 1))[..., 0]
        if fastemit_lambda:
            emit = emit + fastemit_lambda * (emit - emit.detach())
        tmask = torch.arange(t_max, device=lp.device)[None, :] < tl[:, None]
        neg = torch.full((), NEG, dtype=lp.dtype, device=lp.device)
        alpha0 = torch.cat([torch.zeros((bsz, 1), dtype=lp.dtype,
                                        device=lp.device),
                            torch.cumsum(blank_lp[:, :-1, 0], dim=1)], dim=1)
        rows = [torch.where(tmask, alpha0, neg)]
        for u in range(1, u1):
            start = rows[-1] + emit[:, :, u - 1]
            cur = [start[:, 0]]
            for t in range(1, t_max):
                cur.append(torch.logaddexp(start[:, t], cur[-1]
                                           + blank_lp[:, t - 1, u]))
            rows.append(torch.where(tmask, torch.stack(cur, dim=1), neg))
        lattice = torch.stack(rows, dim=2)
        b = torch.arange(bsz, device=lp.device)
        loss = -(lattice[b, tl - 1, ul] + blank_lp[b, tl - 1, ul])
        return _reduce(loss, reduction)
    return call("rnnt_loss", body, [logits, labels, logit_lengths,
                                    label_lengths],
                mask=[True, False, False, False])


__all__ = ["cross_entropy", "fused_linear_cross_entropy",
           "softmax_with_cross_entropy", "nll_loss", "mse_loss", "l1_loss",
           "smooth_l1_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "triplet_margin_loss",
           "sigmoid_focal_loss", "square_error_cost", "ctc_loss", "log_loss",
           "huber_loss", "hsigmoid_loss", "edit_distance", "ctc_align",
           "rnnt_loss"]
