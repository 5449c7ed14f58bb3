"""Cross entropy (counterpart of ``paddle_tpu/nn/functional/loss.py``).

Hard labels with softmax, as the JAX package's streaming formulation
computes them: nll = lse - logits[label] with the max taken out in the
input dtype and the sums in fp32, ``ignore_index``, ``label_smoothing``
and the three reductions. Soft labels, class weights and
``use_softmax=False`` are a later slice.
"""
from __future__ import annotations

import torch


def cross_entropy(input: torch.Tensor, label: torch.Tensor, weight=None,
                  ignore_index: int = -100, reduction: str = "mean",
                  soft_label: bool = False, axis: int = -1,
                  use_softmax: bool = True, label_smoothing: float = 0.0,
                  name=None) -> torch.Tensor:
    """Softmax cross entropy of ``input`` (logits, classes on ``axis``)
    against integer ``label`` (the logits' shape without ``axis``, or
    with a size-1 ``axis``). Returns fp32."""
    if soft_label or weight is not None or not use_softmax:
        raise NotImplementedError(
            "later slice: cross_entropy with soft labels, class weights or "
            "use_softmax=False")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    if label.is_floating_point():
        raise NotImplementedError("later slice: soft (float) labels")
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


__all__ = ["cross_entropy"]
