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
           "topk", "where", "nonzero", "searchsorted", "bucketize", "isin",
           "kthvalue", "masked_scatter", "index_of_max", "shuffle_batch",
           "top_p_sampling", "unique", "unique_consecutive"]


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


@register("top_k", category="search", differentiable=False)
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
    """x where ``condition`` holds, else y; with the condition alone,
    the coordinates of its nonzero elements (``nonzero(condition,
    as_tuple=True)``)."""
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
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


@register("nonzero", category="search", differentiable=False)
def nonzero(x, as_tuple=False, name=None):
    """The coordinates of x's nonzero elements: (n, ndim) int64, or one
    1-D tensor a dim with ``as_tuple`` (a data-dependent shape: the
    count is read on the host)."""
    def f(a):
        return tuple(torch.nonzero(a, as_tuple=True)) if as_tuple \
            else torch.nonzero(a)
    out = dispatch.call("nonzero", f, [_t(x)])
    return tuple(out) if as_tuple else out


@register("searchsorted", category="search", differentiable=False)
def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    """Insertion positions of ``values`` in the sorted sequence."""
    return dispatch.call("searchsorted", lambda s, v: torch.searchsorted(
        s.contiguous(), v.contiguous(), out_int32=out_int32, right=right),
        [_t(sorted_sequence), _t(values)])


@register("bucketize", category="search", differentiable=False)
def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    """The bucket of each element against sorted 1-D edges."""
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


@register("isin", category="search", differentiable=False)
def isin(x, test_x, assume_unique=False, invert=False, name=None):
    """Whether each element of x is in ``test_x``."""
    return dispatch.call("isin", lambda a, b: torch.isin(
        a, b, assume_unique=assume_unique, invert=invert),
        [_t(x), _t(test_x)])


@register("kthvalue", category="search", differentiable=False)
def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """(k-th smallest value along ``axis``, its index), ties in index
    order (a stable sort)."""
    def f(a):
        ax = axis % a.dim()
        v, i = torch.sort(a, dim=ax, stable=True)
        v, i = v.narrow(ax, k - 1, 1), i.narrow(ax, k - 1, 1)
        return (v, i) if keepdim else (v.squeeze(ax), i.squeeze(ax))
    v, i = dispatch.call("kthvalue", f, [_t(x)])
    return v, i


@register("masked_scatter", category="search")
def masked_scatter(x, mask, value, name=None):
    """x with its True-mask positions (in flat order) taken from
    ``value``'s elements in order. Outside a recording the count of True
    positions is checked against ``value``'s size (a host read, as the
    JAX package makes eagerly)."""
    from ..core.tensor import active_capture
    xt, mt, vt = _t(x), _t(mask), _t(value)
    if active_capture() is None and not dispatch.in_branch_trace():
        needed = int(torch.broadcast_to(mt._data.bool(),
                                        xt._data.shape).sum())
        if vt.size < needed:
            raise ValueError(
                f"masked_scatter needs value with >= {needed} elements "
                f"(number of True mask positions), got {vt.size}")

    def f(a, m, v):
        mb = torch.broadcast_to(m.bool(), a.shape).reshape(-1)
        take = torch.cumsum(mb.long(), 0) - 1
        vflat = v.reshape(-1).to(a.dtype)
        got = vflat[take.clamp(0, vflat.numel() - 1)]
        return torch.where(mb, got, a.reshape(-1)).reshape(a.shape)
    return dispatch.call("masked_scatter", f, [xt, mt, vt],
                         differentiable_mask=[True, False, True])


@register("index_of_max", category="search", differentiable=False)
def index_of_max(x):
    """The flat index of the maximum."""
    return argmax(x)


@register("shuffle_batch", category="search", differentiable=False)
def shuffle_batch(x, seed=None, name=None):
    """x's rows in a random order (from ``seed``, else the device's
    generator)."""
    from ..core.generator import default_generator
    from ..core.tensor import graph_break
    graph_break("paddle.shuffle_batch")
    xt = _t(x)
    dev = xt._data.device
    g = (default_generator(dev) if seed is None
         else torch.Generator(device=dev).manual_seed(int(seed)))
    perm = torch.randperm(xt.shape[0], generator=g, device=dev)
    return dispatch.call("shuffle_batch", lambda a, p: a[p],
                         [xt, Tensor(perm)],
                         differentiable_mask=[True, False])


@register("top_p_sampling", category="search", differentiable=False)
def top_p_sampling(x, ps, threshold=None, seed=None, name=None):
    """(probability, id) of one token drawn per row of probabilities x
    (B, V) from its nucleus of mass ps (B,); probabilities below
    ``threshold`` never enter it. Uniforms from ``seed`` (>= 0), else the
    device's generator."""
    from ..core.generator import default_generator
    from ..core.tensor import graph_break
    graph_break("paddle.top_p_sampling")
    xt, pt = _t(x), _t(ps)
    dev = xt._data.device
    g = (torch.Generator(device=dev).manual_seed(int(seed))
         if seed is not None and seed >= 0 else default_generator(dev))
    u = torch.rand(tuple(xt.shape), generator=g, device=dev).clamp_min(1e-20)

    def f(probs, p, uu):
        if threshold is not None:
            probs = torch.where(probs >= threshold, probs,
                                torch.zeros_like(probs))
        ids = nucleus_sample_ids(probs, p.reshape(-1), uu)
        return torch.gather(probs, -1, ids), ids
    pr, ids = dispatch.call("top_p_sampling", f, [xt, pt, Tensor(u)],
                            differentiable_mask=[False] * 3)
    return pr, ids


@register("unique", category="search", differentiable=False)
def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """The sorted distinct values (of the flattened x, or slices along
    ``axis``), with the first index, the inverse and the counts on
    request (a data-dependent shape)."""
    d = convert_dtype(dtype)

    def f(a):
        shape = a.shape
        if axis is None:
            a = a.reshape(-1)
        ax = 0 if axis is None else axis
        # dim=None on the flattened x: torch's flat path (its dim=0 path
        # sorts rows as tuples, many times slower)
        vals, inv, cnt = torch.unique(a, sorted=True, return_inverse=True,
                                      return_counts=True,
                                      dim=None if axis is None else ax)
        outs = [vals]
        if return_index:
            n = a.shape[ax]
            first = torch.full((vals.shape[ax],), n, dtype=torch.long,
                               device=a.device)
            first.scatter_reduce_(0, inv.reshape(-1), torch.arange(
                n, device=a.device), "amin")
            outs.append(first.to(d))
        if return_inverse:       # x's shape without an axis, as numpy's
            outs.append((inv.reshape(shape) if axis is None else inv).to(d))
        if return_counts:
            outs.append(cnt.to(d))
        return tuple(outs) if len(outs) > 1 else outs[0]
    out = dispatch.call("unique", f, [_t(x)])
    return tuple(out) if isinstance(out, list) else out


@register("unique_consecutive", category="search", differentiable=False)
def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    """Each run of equal consecutive values (slices along ``axis``) once,
    with the inverse and the run lengths on request."""
    d = convert_dtype(dtype)

    def f(a):
        vals, inv, cnt = torch.unique_consecutive(
            a, return_inverse=True, return_counts=True, dim=axis)
        outs = [vals] + ([inv.reshape(-1).to(d)] if return_inverse else []) \
            + ([cnt.to(d)] if return_counts else [])
        return tuple(outs) if len(outs) > 1 else outs[0]
    out = dispatch.call("unique_consecutive", f, [_t(x)])
    return tuple(out) if isinstance(out, list) else out
