"""Shape, joining, splitting, gather/scatter and slicing ops (counterpart
of ``paddle_tpu/ops/manipulation.py``): each a plain torch body behind
``dispatch.call``. Index arguments are not differentiable
(``differentiable_mask``). In-place variants (``reshape_``, ...) swap the
tensor's payload, as the JAX package's do.
"""
from __future__ import annotations

import builtins
from typing import Sequence

import torch

from ..core import dispatch
from ..core.dtype import convert_dtype
from ..core.tensor import Tensor, as_tensor
from .registry import register

__all__ = [
    "reshape", "reshape_", "view", "view_as", "flatten", "squeeze",
    "squeeze_", "unsqueeze", "unsqueeze_", "transpose", "moveaxis",
    "swapaxes", "concat", "stack", "unstack", "split", "chunk", "unbind",
    "tile", "expand", "expand_as", "broadcast_to", "flip", "roll",
    "repeat_interleave", "gather", "gather_nd", "scatter", "index_select",
    "take_along_axis", "put_along_axis", "masked_select", "masked_fill",
    "slice", "numel", "diagonal", "as_complex", "as_real", "atleast_1d",
    "atleast_2d", "atleast_3d", "broadcast_tensors", "crop", "diag_embed",
    "index_add", "index_put", "index_sample", "kron", "rot90",
    "scatter_add", "scatter_nd_add", "select_scatter", "shard_index",
    "slice_scatter", "strided_slice", "take", "tensor_split", "tensordot",
]


def _t(x):
    return x if isinstance(x, Tensor) else as_tensor(x)


def _int(v):
    """A size as an int; a symbolic size (``torch.export``) passes as it
    is, so an exported program keeps its dynamic dims."""
    if isinstance(v, Tensor):
        return int(v.item())
    return v if isinstance(v, torch.SymInt) else int(v)


def _ints(seq):
    if isinstance(seq, Tensor):
        return tuple(int(v) for v in seq.tolist())
    return tuple(_int(v) for v in seq)


def _swap(x: Tensor, out: Tensor) -> Tensor:
    x._swap_payload(out._data)
    return x


@register("reshape", category="manipulation")
def reshape(x, shape, name=None):
    """A new shape, one dim inferred from -1."""
    shape = _ints(shape)
    return dispatch.call("reshape", lambda a: a.reshape(shape), [_t(x)])


def reshape_(x, shape, name=None):
    return _swap(x, reshape(x, shape))


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    d = convert_dtype(shape_or_dtype)
    return dispatch.call("view_dtype", lambda a: a.view(d), [_t(x)])


def view_as(x, other, name=None):
    return reshape(x, other.shape)


@register("flatten", category="manipulation")
def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Dims [start_axis, stop_axis] collapsed into one."""
    xt = _t(x)
    nd = xt.ndim
    s = start_axis % nd if nd else 0
    e = stop_axis % nd if nd else 0

    def f(a):
        if a.dim() == 0:
            return a.reshape(1)
        return a.flatten(s, e)
    return dispatch.call("flatten", f, [xt],
                         export_attrs=lambda: {"start_axis": s,
                                               "stop_axis": e})


@register("squeeze", category="manipulation")
def squeeze(x, axis=None, name=None):
    """Size-1 dims dropped, all or those of ``axis`` (a listed dim of
    another size stays)."""
    xt = _t(x)
    if axis is None:
        return dispatch.call("squeeze", torch.squeeze, [xt])
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    ax = tuple(a % max(xt.ndim, 1) for a in axes if xt.shape[a] == 1)
    return dispatch.call("squeeze", lambda a: a.squeeze(ax) if ax else a,
                         [xt])


def squeeze_(x, axis=None, name=None):
    return _swap(x, squeeze(x, axis))


@register("unsqueeze", category="manipulation")
def unsqueeze(x, axis, name=None):
    """Size-1 dims inserted at ``axis`` (positions in the output)."""
    axes = _ints(axis if isinstance(axis, (list, tuple)) else [axis])

    def f(a):
        nd = a.dim() + len(axes)
        for ax in sorted(v % nd for v in axes):
            a = a.unsqueeze(ax)
        return a
    return dispatch.call("unsqueeze", f, [_t(x)])


def unsqueeze_(x, axis, name=None):
    return _swap(x, unsqueeze(x, axis))


@register("transpose", category="manipulation")
def transpose(x, perm=None, name=None):
    """Dims permuted by ``perm`` (reversed when None)."""
    xt = _t(x)
    perm = (tuple(reversed(range(xt.ndim))) if perm is None
            else tuple(int(p) for p in perm))
    return dispatch.call("transpose", lambda a: a.permute(perm), [xt])


def moveaxis(x, source, destination, name=None):
    return dispatch.call("moveaxis", lambda a: torch.movedim(
        a, source, destination), [_t(x)])


def swapaxes(x, axis0, axis1, name=None):
    return dispatch.call("swapaxes", lambda a: a.transpose(axis0, axis1),
                         [_t(x)])


@register("concat", category="manipulation")
def concat(x: Sequence, axis=0, name=None):
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    return dispatch.call("concat", lambda *xs: torch.cat(xs, dim=axis),
                         [_t(v) for v in x])


@register("stack", category="manipulation")
def stack(x: Sequence, axis=0, name=None):
    return dispatch.call("stack", lambda *xs: torch.stack(xs, dim=axis),
                         [_t(v) for v in x])


def unstack(x, axis=0, num=None, name=None):
    return list(dispatch.call("unstack", lambda a: a.unbind(axis), [_t(x)]))


@register("split", category="manipulation")
def split(x, num_or_sections, axis=0, name=None):
    """``num_or_sections`` equal parts (they must divide the dim), or parts
    of the listed sizes (one may be -1)."""
    xt = _t(x)
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    ax = axis % xt.ndim
    total = xt.shape[ax]
    if isinstance(num_or_sections, int):
        if total % num_or_sections:
            raise ValueError(f"split: {total} is not divisible into "
                             f"{num_or_sections} equal parts")
        secs = [total // num_or_sections] * num_or_sections
    else:
        secs = list(_ints(num_or_sections))
        if -1 in secs:
            rest = total - sum(s for s in secs if s != -1)
            secs = [rest if s == -1 else s for s in secs]
    return list(dispatch.call("split", lambda a: a.split(secs, dim=ax),
                              [xt]))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(x, axis=0, name=None):
    return unstack(x, axis)


@register("tile", category="manipulation")
def tile(x, repeat_times, name=None):
    reps = _ints(repeat_times)
    return dispatch.call("tile", lambda a: a.tile(reps), [_t(x)])


@register("expand", category="manipulation")
def expand(x, shape, name=None):
    """Size-1 dims broadcast up to ``shape`` (-1 keeps a dim)."""
    xt = _t(x)
    shape = list(_ints(shape))
    cur = [1] * (len(shape) - xt.ndim) + list(xt.shape)
    tgt = tuple(c if s == -1 else s for s, c in zip(shape, cur))
    return dispatch.call("expand", lambda a: a.broadcast_to(tgt), [xt])


def expand_as(x, y, name=None):
    return expand(x, y.shape)


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


@register("flip", category="manipulation")
def flip(x, axis, name=None):
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    return dispatch.call("flip", lambda a: a.flip(ax), [_t(x)])


@register("roll", category="manipulation")
def roll(x, shifts, axis=None, name=None):
    return dispatch.call("roll", lambda a: torch.roll(a, shifts, axis),
                         [_t(x)])


def repeat_interleave(x, repeats, axis=None, name=None):
    if isinstance(repeats, Tensor):
        return dispatch.call("repeat_interleave",
                             lambda a, r: torch.repeat_interleave(a, r, axis),
                             [_t(x), repeats],
                             differentiable_mask=[True, False])
    return dispatch.call("repeat_interleave", lambda a: torch.repeat_interleave(
        a, repeats, axis), [_t(x)])


# ----------------------------------------------------------- gather/scatter
@register("gather", category="indexing")
def gather(x, index, axis=0, name=None):
    """Entries of ``x`` at the 1-D ``index`` along ``axis``."""
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    return dispatch.call("gather", lambda a, i: a.index_select(
        axis, i.reshape(-1).long()), [_t(x), _t(index)],
        differentiable_mask=[True, False])


@register("gather_nd", category="indexing")
def gather_nd(x, index, name=None):
    """Slices of ``x`` at the index tuples of ``index``'s last dim."""
    def f(a, idx):
        return a[tuple(idx.long().movedim(-1, 0))]
    return dispatch.call("gather_nd", f, [_t(x), _t(index)],
                         differentiable_mask=[True, False])


@register("scatter", category="indexing")
def scatter(x, index, updates, overwrite=True, name=None):
    """Rows of ``updates`` written into ``x`` at ``index``: overwritten,
    or summed over duplicates into zeroed rows."""
    def f(a, idx, upd):
        idx = idx.reshape(-1).long()
        if overwrite:
            return a.index_put((idx,), upd)
        zeroed = a.index_put((idx,), torch.zeros_like(upd))
        return zeroed.index_put((idx,), upd, accumulate=True)
    return dispatch.call("scatter", f, [_t(x), _t(index), _t(updates)],
                         differentiable_mask=[True, False, True])


@register("index_select", category="indexing")
def index_select(x, index, axis=0, name=None):
    return gather(x, index, axis)


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    return dispatch.call("take_along_axis", lambda a, i: torch.take_along_dim(
        a, i.long(), axis), [_t(arr), _t(indices)],
        differentiable_mask=[True, False])


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    """Values scattered along ``axis`` at ``indices``: assigned, added
    (``"add"``/``"sum"``) or multiplied (``"mul"``/``"multiply"``)."""
    modes = {"assign": None, "add": "sum", "sum": "sum", "mul": "prod",
             "multiply": "prod"}
    if reduce not in modes:
        raise ValueError(f"unsupported reduce {reduce}")

    def f(a, i, v):
        i = i.long()
        v = v.to(a.dtype).broadcast_to(i.shape)
        if modes[reduce] is None:
            return a.scatter(axis, i, v)
        return a.scatter_reduce(axis, i, v, modes[reduce])
    return dispatch.call("put_along_axis", f,
                         [_t(arr), _t(indices), _t(values)],
                         differentiable_mask=[True, False, True])


@register("masked_select", category="indexing", differentiable=False)
def masked_select(x, mask, name=None):
    """The 1-D tensor of x's elements where ``mask`` holds."""
    return dispatch.call("masked_select", lambda a, m: a[m.bool()],
                         [_t(x), _t(mask)], differentiable_mask=[True, False])


def masked_fill(x, mask, value, name=None):
    v = value.item() if isinstance(value, Tensor) else value
    return dispatch.call("masked_fill", lambda a, m: a.masked_fill(
        m.bool(), v), [_t(x), _t(mask)], differentiable_mask=[True, False])


@register("slice", category="manipulation")
def slice(x, axes, starts, ends, name=None):
    """[starts, ends) along ``axes``."""
    xt = _t(x)
    sl = [builtins.slice(None)] * xt.ndim
    for ax, st, en in zip(axes, _ints(starts), _ints(ends)):
        sl[ax] = builtins.slice(st, en)
    sl = tuple(sl)
    return dispatch.call("slice", lambda a: a[sl], [xt])


def numel(x, name=None):
    """A 0-d int64 tensor holding x's element count."""
    xt = _t(x)
    return Tensor(torch.full((), xt.size, dtype=torch.int64,
                             device=xt._data.device))


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return dispatch.call("diagonal", lambda a: torch.diagonal(
        a, offset, axis1, axis2), [_t(x)])


def _new(out: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``out``, or a view of it when torch handed back the input itself
    (an op's output is a value of its own)."""
    return out.view_as(out) if out is a else out


def as_complex(x, name=None):
    """Trailing [real, imag] pairs as complex numbers."""
    return dispatch.call("as_complex", lambda a: torch.complex(
        a[..., 0], a[..., 1]), [_t(x)])


def as_real(x, name=None):
    """A complex tensor as trailing [real, imag] pairs."""
    return dispatch.call("as_real", lambda a: torch.stack(
        [a.real, a.imag], -1), [_t(x)])


def _atleast(name, tfn, inputs):
    outs = [dispatch.call(name, lambda a: _new(tfn(a), a), [_t(v)])
            for v in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_1d(*inputs, name=None):
    return _atleast("atleast_1d", torch.atleast_1d, inputs)


def atleast_2d(*inputs, name=None):
    return _atleast("atleast_2d", torch.atleast_2d, inputs)


def atleast_3d(*inputs, name=None):
    return _atleast("atleast_3d", torch.atleast_3d, inputs)


def broadcast_tensors(inputs, name=None):
    """The tensors broadcast to their common shape."""
    return list(dispatch.call("broadcast_tensors", lambda *xs: tuple(
        o.contiguous() for o in torch.broadcast_tensors(*xs)),
        [_t(v) for v in inputs]))


def crop(x, shape=None, offsets=None, name=None):
    """The box of ``shape`` (-1: to the end) at ``offsets``."""
    xt = _t(x)
    shape = _ints(shape)
    offsets = _ints(offsets) if offsets is not None else (0,) * xt.ndim
    sl = tuple(builtins.slice(o, o + n if n != -1 else None)
               for o, n in zip(offsets, shape))
    return dispatch.call("crop", lambda a: a[sl], [xt])


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    """The last dim as the ``offset`` diagonal of new (dim1, dim2)
    planes."""
    return dispatch.call("diag_embed", lambda a: torch.diag_embed(
        a, offset, dim1, dim2), [_t(x)])


def index_add(x, index, axis, value, name=None):
    """Rows of ``value`` added at ``index`` along ``axis`` (duplicates
    sum)."""
    return dispatch.call("index_add", lambda a, i, v: torch.index_add(
        a, axis, i.reshape(-1).long(), v.to(a.dtype)),
        [_t(x), _t(index), _t(value)], differentiable_mask=[True, False, True])


def index_put(x, indices, value, accumulate=False, name=None):
    """``value`` written (or added, ``accumulate``) at the tuple of index
    tensors."""
    idx = [_t(i) for i in indices]

    def f(a, v, *ix):
        ix = tuple(i if i.dtype == torch.bool else i.long() for i in ix)
        return a.index_put(ix, v.to(a.dtype), accumulate=accumulate)
    return dispatch.call("index_put", f, [_t(x), _t(value)] + idx,
                         differentiable_mask=[True, True] + [False] * len(idx))


def index_sample(x, index, name=None):
    """out[i, j] = x[i, index[i, j]]."""
    return dispatch.call("index_sample", lambda a, i: torch.take_along_dim(
        a, i.long(), 1), [_t(x), _t(index)], differentiable_mask=[True, False])


def kron(x, y, name=None):
    return dispatch.call("kron", torch.kron, [_t(x), _t(y)])


def rot90(x, k=1, axes=(0, 1), name=None):
    """Rotate by k quarter turns in the plane of ``axes``."""
    return dispatch.call("rot90", lambda a: torch.rot90(
        a, k, list(axes)), [_t(x)])


@register("scatter_add", category="indexing")
def scatter_add(x, index, updates, name=None):
    """Rows of ``updates`` added into x at ``index`` along dim 0
    (duplicates sum)."""
    return dispatch.call("scatter_add", lambda a, i, u: torch.index_add(
        a, 0, i.reshape(-1).long(), u.to(a.dtype)),
        [_t(x), _t(index), _t(updates)],
        differentiable_mask=[True, False, True])


@register("scatter_nd_add", category="indexing")
def scatter_nd_add(x, index, updates, name=None):
    """``updates`` added into x at the multi-dim ``index`` rows."""
    return dispatch.call("scatter_nd_add", lambda a, i, u: a.index_put(
        tuple(i.long().movedim(-1, 0)), u.to(a.dtype), accumulate=True),
        [_t(x), _t(index), _t(updates)],
        differentiable_mask=[True, False, True])


def select_scatter(x, value, axis, index, name=None):
    """``value`` written at position ``index`` of ``axis``."""
    return dispatch.call("select_scatter", lambda a, v: torch.select_scatter(
        a, v.to(a.dtype), axis, index), [_t(x), _t(value)])


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """Global ids of shard ``shard_id`` as shard-local ids, the rest
    ``ignore_value``."""
    size = index_num // nshards
    return dispatch.call("shard_index", lambda a: torch.where(
        a // size == shard_id, a % size, torch.full_like(a, ignore_value)),
        [_t(input)])


def _strided(shape, axes, starts, ends, strides):
    """Python slices for the strided region, or per-dim index tensors
    (as numpy's ix_) when a stride is negative (torch slices take none)."""
    sl = [builtins.slice(None)] * len(shape)
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        sl[ax] = builtins.slice(int(st), int(en), int(sd))
    if builtins.all((s.step or 1) > 0 for s in sl):
        return tuple(sl), None
    # an empty region gets an empty index: a torch arange over an empty
    # negative-step range raises instead
    idx = [torch.arange(*s.indices(n)) if len(range(*s.indices(n)))
           else torch.empty(0, dtype=torch.long) for s, n in zip(sl, shape)]
    return None, idx


def _ix(idx, device):
    nd = len(idx)
    return tuple(i.to(device).reshape([-1 if k == d else 1
                                       for k in range(nd)])
                 for d, i in enumerate(idx))


def strided_slice(x, axes, starts, ends, strides, name=None):
    """x[start:end:stride] along ``axes`` (negative strides too)."""
    xt = _t(x)
    sl, idx = _strided(xt.shape, axes, starts, ends, strides)
    if sl is not None:
        return dispatch.call("strided_slice", lambda a: a[sl], [xt])
    return dispatch.call("strided_slice", lambda a: a[_ix(idx, a.device)],
                         [xt])


def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    """``value`` written into x[start:end:stride] along ``axes``."""
    xt = _t(x)
    sl, idx = _strided(xt.shape, axes, starts, ends, strides)

    def f(a, v):
        out = a.clone()
        out[sl if sl is not None else _ix(idx, a.device)] = v.to(a.dtype)
        return out
    return dispatch.call("slice_scatter", f, [xt, _t(value)])


def take(x, index, mode="raise", name=None):
    """Elements of the flattened x at ``index``: clipped into range with
    ``mode="clip"``, else wrapped (as the JAX package does for "raise"
    too)."""
    def f(a, i):
        flat = a.reshape(-1)
        i = i.long()
        i = i.clamp(0, flat.numel() - 1) if mode == "clip" \
            else torch.remainder(i, flat.numel())
        return flat[i]
    return dispatch.call("take", f, [_t(x), _t(index)],
                         differentiable_mask=[True, False])


def tensor_split(x, num_or_indices, axis=0, name=None):
    """n parts (the first ones one longer when n does not divide the
    dim), or the parts between ``indices``."""
    arg = num_or_indices if isinstance(num_or_indices, int) \
        else list(num_or_indices)
    return list(dispatch.call("tensor_split", lambda a: tuple(
        torch.tensor_split(a, arg, axis)), [_t(x)]))


def tensordot(x, y, axes=2, name=None):
    """Contract the given axes of x and y."""
    ax = axes if isinstance(axes, int) else [list(a) if isinstance(
        a, (list, tuple)) else [a] for a in axes]
    return dispatch.call("tensordot", lambda a, b: torch.tensordot(
        a, b, dims=ax), [_t(x), _t(y)])
