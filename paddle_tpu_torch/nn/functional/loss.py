"""Cross entropy and the fused chunked LM-head loss (counterparts of
``cross_entropy`` and ``fused_linear_cross_entropy`` in
``paddle_tpu/nn/functional/loss.py``).

Hard labels with softmax, as the JAX package's streaming formulation
computes them: nll = lse - logits[label] with the max taken out in the
input dtype and the sums in fp32, ``ignore_index``, ``label_smoothing``
and the three reductions. Soft labels, class weights and
``use_softmax=False`` are a later slice. ``cross_entropy`` is on amp's
black list (its logits go to fp32), ``fused_linear_cross_entropy`` on
the white list (x and the weight go to the amp dtype; the LSE stays
fp32).

On Paddle ``Tensor``s each is one op through ``core.dispatch.call`` (the
labels take no gradient) with the same math and the same layouts; on
``torch.Tensor``s, the torch-level function.
"""
from __future__ import annotations

import torch

from ...amp.state import amp_cast
from ...core import dispatch
from ...core.tensor import Tensor, as_tensor


def cross_entropy(input, label, weight=None, ignore_index: int = -100,
                  reduction: str = "mean", soft_label: bool = False,
                  axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0, name=None):
    """Softmax cross entropy of ``input`` (logits, classes on ``axis``)
    against integer ``label`` (the logits' shape without ``axis``, or
    with a size-1 ``axis``). Returns fp32."""
    if isinstance(input, Tensor):
        return dispatch.call("cross_entropy", lambda a, lab: cross_entropy(
            a, lab, weight, ignore_index, reduction, soft_label, axis,
            use_softmax, label_smoothing), [input, as_tensor(label)],
            differentiable_mask=[True, False])
    if soft_label or weight is not None or not use_softmax:
        raise NotImplementedError(
            "later slice: cross_entropy with soft labels, class weights or "
            "use_softmax=False")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    if label.is_floating_point():
        raise NotImplementedError("later slice: soft (float) labels")
    (input,) = amp_cast("cross_entropy", input)
    ax = axis % input.dim()
    lab = label.long()
    if lab.dim() == input.dim() and lab.shape[ax] == 1:
        lab = lab.squeeze(ax)
    # the max leaves autograd (the JAX package's stop_gradient); the shift
    # runs in the input dtype, the sums in fp32
    m = input.detach().amax(dim=ax, keepdim=True)
    shifted = (input - m).float()
    lse = torch.log(torch.exp(shifted).sum(dim=ax)) + m.squeeze(ax).float()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    picked = input.gather(ax, safe.unsqueeze(ax)).squeeze(ax).float()
    nll = lse - picked
    if label_smoothing > 0:
        smooth = lse - input.float().mean(dim=ax)
        nll = (1 - label_smoothing) * nll + label_smoothing * smooth
    return _hard_label_reduce(nll, valid, reduction)


def _hard_label_reduce(nll: torch.Tensor, valid: torch.Tensor,
                       reduction: str) -> torch.Tensor:
    """The ignore_index epilogue: ignored positions give 0, and "mean"
    divides by the number of the others (at least 1)."""
    nll = torch.where(valid, nll, torch.zeros((), dtype=nll.dtype,
                                              device=nll.device))
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


__all__ = ["cross_entropy", "fused_linear_cross_entropy"]
