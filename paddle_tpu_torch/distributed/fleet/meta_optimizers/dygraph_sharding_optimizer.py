"""ZeRO stage 1: optimizer state sharded over the ``sharding`` axis
(counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers/dygraph_sharding_optimizer.py``;
reference dygraph_optimizer/dygraph_sharding_optimizer.py:44).

The JAX package lays every state tensor out sharded over the axis and
lets the partitioner split the update. The port is the reference's
design: the greedy owner map ``partition_parameters`` (largest first,
each to the least-loaded rank; the JAX package's map) gives every
parameter one owner on the sharding axis; the inner optimizer is made to
hold and step only this rank's parameters (so it keeps moments and
master weights for them alone), and after its step each owner broadcasts
its updated parameters to the sharding group
(``_sharding_sync_parameters``), one flat buffer an owner and dtype. The
gradients are averaged over the data ranks (dp and sharding) before the
step by ``HybridParallelOptimizer``; a global-norm clip sums its squares
over the sharding group (``HybridParallelClipGrad``).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ...communication import collective as C


def partition_parameters(params, degree: int) -> Dict[int, list]:
    """Greedy size-balanced owners (reference :116; the JAX package's
    ``_partition_parameters``): largest first, each to the rank with the
    fewest values so far (the lowest such rank on a tie)."""
    sizes = [0.0] * degree
    mapping: Dict[int, list] = {i: [] for i in range(degree)}
    for p in sorted(params,
                    key=lambda q: int(np.prod(q.shape) if q.shape else 1),
                    reverse=True):
        rank = int(np.argmin(sizes))
        mapping[rank].append(p)
        sizes[rank] += int(np.prod(p.shape) if p.shape else 1)
    return mapping


class DygraphShardingOptimizer:
    """Wraps an inner optimizer; duck type of the reference class
    (``step``, ``clear_grad``, ``state_dict``, ``_rank2params``)."""

    def __init__(self, optimizer, hcg):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._group = hcg.get_sharding_parallel_group()
        self._degree = hcg.get_sharding_parallel_world_size()
        self._rank = hcg.get_sharding_parallel_rank()
        self._parameter_list = list(optimizer._parameter_list)
        self._rank2params = partition_parameters(self._parameter_list,
                                                 self._degree)
        self._param2rank = {id(p): r for r, ps in self._rank2params.items()
                            for p in ps}
        mine = {id(p) for p in self._rank2params[self._rank]}
        keep = [(n, p) for n, p in zip(optimizer._names,
                                       self._parameter_list) if id(p) in mine]
        optimizer._names = [n for n, _ in keep]
        optimizer._parameter_list = [p for _, p in keep]

    def step(self):
        self._inner_opt.step()
        self._sharding_sync_parameters()

    @torch.no_grad()
    def _sharding_sync_parameters(self):
        """Each owner broadcasts its parameters over the sharding group
        (reference :358)."""
        if self._degree == 1:
            return
        for r, params in self._rank2params.items():
            by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
            for p in params:
                by_dtype.setdefault(p.dtype, []).append(p)
            for ps in by_dtype.values():
                flat = _flatten_dense_tensors([p.detach() for p in ps])
                C.broadcast(flat, src=self._group.ranks[r], group=self._group)
                if r != self._rank:
                    for p, v in zip(ps, _unflatten_dense_tensors(flat, ps)):
                        p.copy_(v)

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, *args, **kwargs):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)
