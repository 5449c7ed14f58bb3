"""Search ops (counterpart of part of ``paddle_tpu/ops/search.py``):
``argmax``, ``argmin``, ``argsort``, ``sort``, ``topk`` and ``where``,
each a plain torch body behind ``dispatch.call``, nucleus sampling,
the beam-search backtrace ``gather_tree`` and ``class_center_sample``.
The rest of the JAX file is still to port (ROADMAP).

The JAX ``nucleus_sample_ids`` draws its uniforms from a key inside; this one takes
them as an argument, so a caller chooses where they come from (the
serving engine's counter-based draw, or JAX's own draw in a test) and
the same uniforms give the same ids in both packages. The JAX package's
``top_p_sampling`` (threshold, global or seeded key) is not ported.
"""
from __future__ import annotations

import torch

from ..core import dispatch
from ..core.dtype import convert_dtype
from ..core.tensor import Tensor, as_tensor
from .registry import register

__all__ = ["nucleus_sample_ids", "argmax", "argmin", "argsort", "sort",
           "topk", "where"]


def _t(x):
    return x if isinstance(x, Tensor) else as_tensor(x)


def _arg(name, tfn, x, axis, keepdim, dtype):
    d = convert_dtype(dtype)

    def f(a):
        if axis is None:
            out = tfn(a.reshape(-1))
            return (out.reshape((1,) * a.dim()) if keepdim else out).to(d)
        return tfn(a, dim=axis, keepdim=keepdim).to(d)
    return dispatch.call(name, f, [_t(x)])


@register("argmax", category="search", differentiable=False)
def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    """Index of the maximum along ``axis`` (of the flattened tensor when
    None)."""
    return _arg("argmax", torch.argmax, x, axis, keepdim, dtype)


@register("argmin", category="search", differentiable=False)
def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg("argmin", torch.argmin, x, axis, keepdim, dtype)


@register("argsort", category="search", differentiable=False)
def argsort(x, axis=-1, descending=False, stable=False, name=None):
    """Indices that sort along ``axis`` (stable, as the JAX package's)."""
    return dispatch.call("argsort", lambda a: torch.argsort(
        a, dim=axis, descending=descending, stable=True), [_t(x)])


def sort(x, axis=-1, descending=False, stable=False, name=None):
    return dispatch.call("sort", lambda a: torch.sort(
        a, dim=axis, descending=descending, stable=True).values, [_t(x)])


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    """(values, int64 indices) of the k largest (or smallest) along
    ``axis`` (the last when None), as ``lax.top_k`` gives them: always
    sorted (``sorted`` is accepted and ignored, as in the JAX package),
    and among equal values the lower index first, for ``largest=False``
    too. A stable sort of the whole axis, sliced to k."""
    if isinstance(k, Tensor):
        k = int(k.item())
    ax = -1 if axis is None else axis

    def f(a):
        v, i = torch.sort(a, dim=ax, descending=largest, stable=True)
        return v.narrow(ax, 0, k), i.narrow(ax, 0, k)
    v, i = dispatch.call("top_k", f, [_t(x)])
    return v, i


@register("where", category="search")
def where(condition, x=None, y=None, name=None):
    """x where ``condition`` holds, else y."""
    if x is None and y is None:
        raise NotImplementedError(
            "later slice: where(condition) (nonzero coordinates)")
    return dispatch.call("where", lambda c, a, b: torch.where(c.bool(), a, b),
                         [_t(condition), _t(x), _t(y)],
                         differentiable_mask=[False, True, True])


def nucleus_sample_ids(probs: torch.Tensor, p: torch.Tensor,
                       u: torch.Tensor) -> torch.Tensor:
    """Nucleus (top-p) draw from probability rows.

    probs: (B, V); p: (B,) nucleus mass per row; u: (B, V) uniforms in
    [1e-20, 1), read in sorted order (u[b, j] serves row b's j-th most
    probable token, as the JAX draw over the sorted shape does).

    Sort descending (ties keep their index order, as ``jnp.argsort`` of
    ``-probs`` does), keep tokens while the exclusive cumulative mass is
    below p (the top token always), renormalise, and take the Gumbel-max
    draw inside the nucleus. Returns (B, 1) int64 ids.
    """
    sp, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    csum = torch.cumsum(sp, dim=-1)
    keep = (csum - sp) < p[:, None]
    keep[:, 0] = True
    masked = torch.where(keep, sp, torch.zeros_like(sp))
    masked = masked / masked.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    gumbel = -torch.log(-torch.log(u))
    score = torch.where(keep, torch.log(masked + 1e-20) + gumbel,
                        torch.full_like(masked, -float("inf")))
    choice = torch.argmax(score, dim=-1, keepdim=True)
    return torch.gather(order, -1, choice)


@register("gather_tree", category="search", differentiable=False)
def gather_tree(ids, parents, name=None):
    """Beam-search backtrace over (T, B, W) ids and parent beams: from the
    last step, each column follows its parent pointers back."""
    def f(idv, pav):
        t_max, b, w = idv.shape
        rows = torch.arange(b, device=idv.device)[:, None]
        beam = torch.arange(w, device=idv.device)[None].expand(b, w)
        outs = []
        for t in range(t_max - 1, -1, -1):
            outs.append(idv[t][rows, beam])
            beam = pav[t][rows, beam].long()
        return torch.stack(outs[::-1])
    return dispatch.call("gather_tree", f, [_t(ids), _t(parents)],
                         differentiable_mask=[False, False])


@register("class_center_sample", category="search", differentiable=False)
def class_center_sample(label, num_classes, num_samples, group=None,
                        name=None):
    """Every positive class plus random negatives up to ``num_samples``
    (from the device's Paddle-API generator), sorted; returns (the labels
    remapped into the sampled set, the sampled classes). On the host, as
    the JAX package: the positive set depends on the data."""
    from ..core.generator import default_generator
    lt = _t(label)
    dev = lt._data.device
    lab = lt._data.long().reshape(-1).cpu()
    pos = torch.unique(lab)
    if pos.numel() >= num_samples:
        sampled = pos
    else:
        keep = torch.ones(num_classes, dtype=torch.bool)
        keep[pos] = False
        neg_pool = torch.arange(num_classes)[keep]
        perm = torch.randperm(neg_pool.numel(),
                              generator=default_generator(dev),
                              device=dev).cpu()
        sampled = torch.sort(torch.cat(
            [pos, neg_pool[perm[:num_samples - pos.numel()]]])).values
    remap = torch.full((num_classes,), -1, dtype=torch.long)
    remap[sampled] = torch.arange(sampled.numel())
    return (Tensor(remap[lab].reshape(lt._data.shape).to(dev)),
            Tensor(sampled.to(dev)))


__all__ += ["gather_tree", "class_center_sample"]
