"""Megatron-style tensor-parallel layers (counterpart of
``paddle_tpu/distributed/fleet/mpu/mp_layers.py``; reference
fleet/layers/mpu/mp_layers.py: VocabParallelEmbedding :47,
ColumnParallelLinear :334, RowParallelLinear :541, ParallelCrossEntropy
:742).

The JAX layers hold global weights sharded by XLA; the port's hold this
rank's shard, as the reference's do, and call the mp ops around a local
product:

* ``VocabParallelEmbedding``: rows [r V/n, (r+1) V/n) of the table; an
  id outside them gives a zero row, and the rows are summed over mp;
* ``ColumnParallelLinear``: columns r of the weight and bias; the input
  goes through ``_c_identity``, the output is gathered over mp with
  ``gather_output`` (else each rank keeps its columns);
* ``RowParallelLinear``: rows r of the weight; an input not
  ``input_is_parallel`` is split over mp first; the partial products are
  summed over mp, then the (replicated) bias is added;
* ``ParallelCrossEntropy``: softmax cross entropy of vocab-sharded
  logits: the max, the sum of exponentials and the target logit are
  reduced over mp (the full logits are never gathered); returns the
  per-token loss (..., 1), as the JAX layer does.

They are Paddle-API ``Layer``s, in Paddle's (in, out) layout. Each has a
torch-level twin (``TorchColumnParallelLinear`` etc.: ``torch.nn``
modules, torch's (out, in) layout, as ``TorchLinear`` twins ``Linear``)
for the torch-level models. A weight split over mp is marked
``is_distributed``. A twin's ``mp_splits()`` says how each of its
parameters is cut from the full one (``shard``), which the weight carry
function (``models.convert.load_jax_state``) and the models' init use:
``groups=3`` cuts a fused q/k/v projection by thirds first, so that rank
r takes the q, k and v columns of its heads.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from ....core import dispatch
from ....core.tensor import as_tensor
from ....nn import functional as F
from ....nn.layer.layers import Layer
from .mp_ops import _c_concat, _c_identity, _c_split, _mp_allreduce, mp_group
from .random import get_rng_state_tracker


def _rank_degree(group) -> Tuple[int, int]:
    g = mp_group(group)
    return (0, 1) if g is None else (g.rank, g.nranks)


def shard(full, dim: int, rank: int, degree: int, groups: int = 1):
    """Rank ``rank``'s part of ``full`` (numpy or torch) cut into
    ``degree`` along ``dim``; with ``groups``, each of ``groups`` equal
    parts of ``dim`` is cut and rank r's pieces are concatenated."""
    if degree == 1:
        return full
    n = full.shape[dim]
    if n % (groups * degree):
        raise ValueError(f"dim {dim} of size {n} does not cut into "
                         f"{groups} x {degree}")
    step = n // (groups * degree)
    idx = np.concatenate([np.arange(gi * n // groups + rank * step,
                                    gi * n // groups + (rank + 1) * step)
                          for gi in range(groups)])
    if isinstance(full, torch.Tensor):
        return full.index_select(dim, torch.as_tensor(idx,
                                                      device=full.device))
    return np.take(full, idx, axis=dim)


def is_split(p) -> bool:
    """Whether the parameter (or its payload) is split over mp. Not a bare
    ``getattr``: ``torch.Tensor`` has a legacy ``is_distributed()``
    method, which would read as true."""
    return getattr(p, "is_distributed", False) is True


def _check_divides(n: int, degree: int, what: str):
    if n % degree:
        raise ValueError(f"{what} {n} must divide over the mp degree "
                         f"{degree}")


# ------------------------------------------------------ torch-level bodies
def vocab_parallel_embedding(ids: torch.Tensor, weight: torch.Tensor,
                             start: int, group=None) -> torch.Tensor:
    """Rows of the local table (rows [start, start + len)) at ``ids``,
    zero where an id is outside them, summed over mp."""
    ids = ids.long()
    inside = (ids >= start) & (ids < start + weight.shape[0])
    local = torch.where(inside, ids - start, torch.zeros_like(ids))
    out = nn.functional.embedding(local, weight)
    out = out.masked_fill(~inside.unsqueeze(-1), 0.0)
    return _mp_allreduce(out, group)


def column_parallel_linear(x, weight, bias=None, gather_output=True,
                           group=None):
    """x W_r^T + b_r (W_r (out/n, in), torch layout), gathered over mp
    with ``gather_output``."""
    y = F.linear(_c_identity(x, group), weight, bias)
    return _c_concat(y, group, axis=-1) if gather_output else y


def row_parallel_linear(x, weight, bias=None, input_is_parallel=False,
                        group=None):
    """sum over mp of x_r W_r^T (W_r (out, in/n), torch layout), then b."""
    if not input_is_parallel:
        x = _c_split(x, group, axis=-1)
    y = _mp_allreduce(F.linear(x, weight), group)
    return y if bias is None else y + bias.to(y.dtype)


class _VocabParallelCE(torch.autograd.Function):
    """Per-row softmax cross entropy of vocab-sharded logits (N, V/n)
    against global labels (N,), fp32; ignored rows give 0."""

    @staticmethod
    def forward(ctx, logits, labels, start, g, ignore_index):
        x = logits.float()
        m = x.amax(dim=-1)
        if g is not None and g.nranks > 1:
            from ...communication import collective as C
            C.all_reduce(m, op=C.ReduceOp.MAX, group=g)
        e = torch.exp(x - m.unsqueeze(-1))
        width = x.shape[-1]
        inside = (labels >= start) & (labels < start + width)
        idx = torch.where(inside, labels - start, torch.zeros_like(labels))
        picked = torch.where(inside, x.gather(-1, idx.unsqueeze(-1))
                             .squeeze(-1), torch.zeros_like(m))
        sums = torch.stack([e.sum(-1), picked])
        if g is not None and g.nranks > 1:
            from ...communication import collective as C
            C.all_reduce(sums, group=g)
        valid = labels != ignore_index
        loss = torch.log(sums[0]) + m - sums[1]
        loss = torch.where(valid, loss, torch.zeros_like(loss))
        e.div_(sums[0].unsqueeze(-1))
        ctx.save_for_backward(e, idx, inside, valid)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, dloss):
        softmax, idx, inside, valid = ctx.saved_tensors
        grad = softmax.clone()
        rows = torch.arange(grad.shape[0], device=grad.device)
        grad[rows, idx] -= inside.to(grad.dtype)
        grad.mul_((dloss * valid).unsqueeze(-1))
        return grad.to(ctx.dtype), None, None, None, None


def parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           group=None, ignore_index: int = -100
                           ) -> torch.Tensor:
    """Per-token loss (labels' shape, fp32) of logits (..., V/n) sharded
    over mp (rank r holds classes [r V/n, (r+1) V/n))."""
    g = mp_group(group)
    rank = 0 if g is None else g.rank
    width = logits.shape[-1]
    lab = labels.long()
    if lab.dim() == logits.dim():
        lab = lab.squeeze(-1)
    shape = lab.shape
    loss = _VocabParallelCE.apply(logits.reshape(-1, width), lab.reshape(-1),
                                  rank * width, g, ignore_index)
    return loss.reshape(shape)


# ------------------------------------------------------ torch-level twins
class _TorchParallel(nn.Module):
    def _splits(self) -> Dict[str, Tuple[int, int]]:
        raise NotImplementedError

    def mp_splits(self) -> Dict[str, Tuple[int, int]]:
        """parameter name -> (dim, groups) of its cut over mp."""
        return self._splits()

    def full_shape(self, name: str) -> Tuple[int, ...]:
        shape = list(getattr(self, name).shape)
        dim, _ = self._splits()[name]
        shape[dim] *= self.mp_degree
        return tuple(shape)

    def load_full(self, name: str, full: torch.Tensor):
        """Copy this rank's part of the full parameter ``name``."""
        dim, groups = self._splits()[name]
        with torch.no_grad():
            getattr(self, name).copy_(shard(full, dim, self.mp_rank,
                                            self.mp_degree, groups))


class TorchVocabParallelEmbedding(_TorchParallel):
    def __init__(self, num_embeddings, embedding_dim, mp_group=None,
                 device=None, dtype=None):
        super().__init__()
        self.group = mp_group
        self.mp_rank, self.mp_degree = _rank_degree(mp_group)
        _check_divides(num_embeddings, self.mp_degree, "vocab size")
        rows = num_embeddings // self.mp_degree
        self.start = self.mp_rank * rows
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.weight = nn.Parameter(torch.empty(rows, embedding_dim,
                                               device=device, dtype=dtype))
        self.weight.is_distributed = True

    def _splits(self):
        return {"weight": (0, 1)}

    def forward(self, ids):
        return vocab_parallel_embedding(ids, self.weight, self.start,
                                        self.group)


class TorchColumnParallelLinear(_TorchParallel):
    """``groups`` > 1: the output is ``groups`` blocks (a fused q/k/v
    projection: 3), each cut over mp."""

    def __init__(self, in_features, out_features, has_bias=True,
                 gather_output=True, groups=1, mp_group=None, device=None,
                 dtype=None):
        super().__init__()
        self.group = mp_group
        self.mp_rank, self.mp_degree = _rank_degree(mp_group)
        _check_divides(out_features, self.mp_degree * groups,
                       "out_features")
        self.in_features, self.out_features = in_features, out_features
        self.gather_output, self.groups = gather_output, groups
        local = out_features // self.mp_degree
        self.weight = nn.Parameter(torch.empty(local, in_features,
                                               device=device, dtype=dtype))
        self.weight.is_distributed = True
        self.bias = None
        if has_bias:
            self.bias = nn.Parameter(torch.zeros(local, device=device,
                                                 dtype=dtype))
            self.bias.is_distributed = True

    def _splits(self):
        out = {"weight": (0, self.groups)}
        if self.bias is not None:
            out["bias"] = (0, self.groups)
        return out

    def forward(self, x):
        return column_parallel_linear(x, self.weight, self.bias,
                                      self.gather_output, self.group)


class TorchRowParallelLinear(_TorchParallel):
    def __init__(self, in_features, out_features, has_bias=True,
                 input_is_parallel=False, mp_group=None, device=None,
                 dtype=None):
        super().__init__()
        self.group = mp_group
        self.mp_rank, self.mp_degree = _rank_degree(mp_group)
        _check_divides(in_features, self.mp_degree, "in_features")
        self.in_features, self.out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        self.weight = nn.Parameter(torch.empty(
            out_features, in_features // self.mp_degree, device=device,
            dtype=dtype))
        self.weight.is_distributed = True
        self.bias = None
        if has_bias:
            self.bias = nn.Parameter(torch.zeros(out_features, device=device,
                                                 dtype=dtype))

    def _splits(self):
        return {"weight": (1, 1)}

    def forward(self, x):
        return row_parallel_linear(x, self.weight, self.bias,
                                   self.input_is_parallel, self.group)


# ------------------------------------------------------- Paddle-API layers
def _param(layer, shape, attr=None, is_bias=False, distributed=True):
    with get_rng_state_tracker().rng_state():
        p = layer.create_parameter(list(shape), attr=attr, is_bias=is_bias)
    if p is not None:
        p.is_distributed = distributed
        p._data.is_distributed = distributed
    return p


class VocabParallelEmbedding(Layer):
    """Embedding with the vocab dim cut over mp (reference
    mp_layers.py:47); ``weight`` holds this rank's rows."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        self._group = mp_group
        rank, degree = _rank_degree(mp_group)
        _check_divides(num_embeddings, degree, "vocab size")
        self._num_embeddings, self._embedding_dim = (num_embeddings,
                                                     embedding_dim)
        self._start = rank * (num_embeddings // degree)
        self.weight = _param(self, [num_embeddings // degree, embedding_dim],
                             weight_attr)

    def forward(self, x):
        return dispatch.call(
            "vocab_parallel_embedding",
            lambda ids, w: vocab_parallel_embedding(ids, w, self._start,
                                                    self._group),
            [as_tensor(x), self.weight], differentiable_mask=[False, True])


class ColumnParallelLinear(Layer):
    """Linear with the output dim cut over mp (reference
    mp_layers.py:334); ``weight`` (in, out/n), ``bias`` (out/n)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        self._group = mp_group
        _, degree = _rank_degree(mp_group)
        _check_divides(out_features, degree, "out_features")
        self._in_features, self._out_features = in_features, out_features
        self.gather_output = gather_output
        self.weight = _param(self, [in_features, out_features // degree],
                             weight_attr)
        self.bias = None
        if has_bias is None or has_bias:
            self.bias = _param(self, [out_features // degree], is_bias=True)

    def forward(self, x):
        ts = [x, self.weight] + ([self.bias] if self.bias is not None else [])
        return dispatch.call(
            "column_parallel_linear",
            lambda a, w, *b: column_parallel_linear(
                a, w.t(), *b, gather_output=self.gather_output,
                group=self._group), ts)


class RowParallelLinear(Layer):
    """Linear with the input dim cut over mp (reference mp_layers.py:541);
    ``weight`` (in/n, out), ``bias`` (out) replicated."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        self._group = mp_group
        _, degree = _rank_degree(mp_group)
        _check_divides(in_features, degree, "in_features")
        self._in_features, self._out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        self.weight = _param(self, [in_features // degree, out_features],
                             weight_attr)
        self.bias = None
        if has_bias:
            self.bias = _param(self, [out_features], is_bias=True,
                               distributed=False)

    def forward(self, x):
        ts = [x, self.weight] + ([self.bias] if self.bias is not None else [])
        return dispatch.call(
            "row_parallel_linear",
            lambda a, w, *b: row_parallel_linear(
                a, w.t(), *(b or (None,)),
                input_is_parallel=self.input_is_parallel, group=self._group),
            ts)


class ParallelCrossEntropy(Layer):
    """Cross entropy over vocab-sharded logits (reference
    mp_layers.py:742): the per-token loss, (..., 1)."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self._group = mp_group
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return dispatch.call(
            "parallel_cross_entropy",
            lambda x, lab: parallel_cross_entropy(
                x, lab, self._group, self.ignore_index).unsqueeze(-1),
            [input, as_tensor(label)], differentiable_mask=[True, False])


__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy",
           "TorchVocabParallelEmbedding", "TorchColumnParallelLinear",
           "TorchRowParallelLinear", "parallel_cross_entropy", "shard",
           "is_split"]
