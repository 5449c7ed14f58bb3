"""Differentiable model-parallel communication ops (counterpart of
``paddle_tpu/distributed/fleet/mpu/mp_ops.py``; reference
fleet/layers/mpu/mp_ops.py).

The JAX package expresses these as sharding transitions of global arrays
and lets the SPMD partitioner place the collectives. The port is the
reference's rank-local form: each op is a ``torch.autograd.Function``
whose backward is its dual collective over the model-parallel group
(default: the hybrid topology's mp group, else the mesh's ``mp`` axis):

* ``_c_identity``: identity forward, all-reduce (sum) backward;
* ``_mp_allreduce``: all-reduce (sum) forward, identity backward;
* ``_c_split``: this rank's chunk of a dim forward, all-gather backward;
* ``_c_concat``: all-gather along a dim forward, this rank's chunk
  backward.

Each takes a ``torch.Tensor`` or a Paddle ``Tensor`` (through the
dispatcher, so it is recorded as one op). A group of one rank makes each
the identity.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ....core import dispatch
from ....core.tensor import Tensor
from ... import mesh as mesh_mod
from ...communication import collective as C
from ...communication.group import Group


def mp_group(group: Optional[Group] = None) -> Optional[Group]:
    """``group``, else the hybrid topology's mp group, else the current
    mesh's ``mp`` group; None outside a parallel environment."""
    if group is not None:
        return group
    from ..base.topology import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    if hcg is not None:
        return hcg.get_model_parallel_group()
    if dist.is_initialized() and mesh_mod.has_mesh() and \
            "mp" in mesh_mod.get_mesh().shape:
        return mesh_mod.get_mesh().group(("mp",))
    return None


def _size(g: Optional[Group]) -> int:
    return 1 if g is None else g.nranks


def _all_reduce(x: torch.Tensor, g: Group) -> torch.Tensor:
    y = x.contiguous().clone()
    C.all_reduce(y, group=g)
    return y


def _gather(x: torch.Tensor, g: Group, dim: int) -> torch.Tensor:
    parts = []
    C.all_gather(parts, x.contiguous(), group=g)
    return torch.cat(parts, dim=dim)


def _chunk(x: torch.Tensor, g: Group, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    if n % g.nranks:
        raise ValueError(f"dim {dim} of size {n} does not split over "
                         f"{g.nranks} model-parallel ranks")
    return x.chunk(g.nranks, dim)[g.rank].contiguous()


class _CIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy, ctx.g), None


class _MpAllreduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return _all_reduce(x, g)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _CSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _chunk(x, g, dim)

    @staticmethod
    def backward(ctx, dy):
        return _gather(dy, ctx.g, ctx.dim), None, None


class _CConcat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _gather(x, g, dim)

    @staticmethod
    def backward(ctx, dy):
        return _chunk(dy, ctx.g, ctx.dim), None, None


def _apply(name, fn, tensor, g, *args):
    if _size(g) == 1:
        return tensor
    if isinstance(tensor, Tensor):
        return dispatch.call(name, lambda x: fn.apply(x, g, *args), [tensor])
    return fn.apply(tensor, g, *args)


def _c_identity(tensor, group: Optional[Group] = None):
    """Identity forward; backward sums the gradient over the mp group
    (the input of a column-parallel product, replicated over mp)."""
    return _apply("c_identity", _CIdentity, tensor, mp_group(group))


def _mp_allreduce(tensor, group: Optional[Group] = None,
                  use_calc_stream: bool = True):
    """Sum over the mp group forward (the partial products of a
    row-parallel product); identity backward."""
    return _apply("mp_allreduce_sum", _MpAllreduce, tensor, mp_group(group))


def _c_split(tensor, group: Optional[Group] = None, axis: int = -1):
    """This rank's chunk of dim ``axis`` forward; all-gather backward."""
    g = mp_group(group)
    return _apply("c_split", _CSplit, tensor, g,
                  axis % _data_ndim(tensor))


def _c_concat(tensor, group: Optional[Group] = None, axis: int = -1):
    """Every rank's chunk of dim ``axis`` concatenated forward; this
    rank's chunk backward."""
    g = mp_group(group)
    return _apply("c_concat", _CConcat, tensor, g,
                  axis % _data_ndim(tensor))


def _data_ndim(t) -> int:
    return t.ndim if isinstance(t, Tensor) else t.dim()


def split(x, size, operation: str, axis: int = 0, num_partitions: int = 1,
          gather_out: bool = True, weight_attr=None, bias_attr=None,
          name=None):
    """Reference ``paddle.distributed.split``: build a parallel linear
    (``axis=1`` column-, ``axis=0`` row-parallel) or vocab-parallel
    embedding of the global ``size`` and apply it to ``x``."""
    from .mp_layers import (ColumnParallelLinear, RowParallelLinear,
                            VocabParallelEmbedding)
    if operation == "linear":
        in_f, out_f = size
        if axis == 1:
            layer = ColumnParallelLinear(in_f, out_f, weight_attr=weight_attr,
                                         has_bias=bias_attr is not False,
                                         gather_output=gather_out)
        else:
            layer = RowParallelLinear(in_f, out_f, weight_attr=weight_attr,
                                      has_bias=bias_attr is not False,
                                      input_is_parallel=False)
        return layer(x)
    if operation == "embedding":
        num, dim = size
        layer = VocabParallelEmbedding(num, dim, weight_attr=weight_attr)
        return layer(x)
    raise ValueError(f"unsupported split operation {operation!r}")
