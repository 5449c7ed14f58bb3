"""Hybrid-parallel sync utilities (counterpart of
``paddle_tpu/distributed/fleet/utils/hybrid_parallel_util.py``; reference
fleet/utils/hybrid_parallel_util.py:168-275).

The JAX package's parameters are global arrays, so its broadcasts only
re-assert placements. The port's ranks hold copies, as the reference's
do: ``broadcast_*_parameters`` send the source rank's parameters (and
buffers) to the rest of its group over that axis (mp: the parameters
not split over mp), and ``fused_allreduce_gradients`` averages the
gradients over the data-parallel group in the flat buckets of
``DataParallel``'s reducer (``parallel.build_buckets``, at its default
``comm_buffer_size``).
"""
from __future__ import annotations

from typing import Iterable

import torch

from ....core.tensor import Tensor
from ...communication import collective as C
from ...parallel import (COMM_BUFFER_SIZE, MB, build_buckets, launch_mean,
                         sync_params_buffers, write_back)
from ..base.topology import get_hybrid_communicate_group


def _hcg(hcg):
    hcg = hcg or get_hybrid_communicate_group()
    if hcg is None:
        raise RuntimeError("no hybrid topology: call fleet.init() first")
    return hcg


def broadcast_dp_parameters(model, hcg=None):
    hcg = _hcg(hcg)
    sync_params_buffers(model, hcg.get_data_parallel_group(),
                        hcg.get_data_parallel_group_src_rank())
    return model


def broadcast_mp_parameters(model, hcg=None):
    hcg = _hcg(hcg)
    sync_params_buffers(model, hcg.get_model_parallel_group(),
                        hcg.get_model_parallel_group_src_rank(),
                        is_model_parallel=True)
    return model


def broadcast_sharding_parameters(model, hcg=None):
    hcg = _hcg(hcg)
    sync_params_buffers(model, hcg.get_sharding_parallel_group(),
                        hcg.get_sharding_parallel_group_src_rank())
    return model


def broadcast_sep_parameters(model, hcg=None):
    hcg = _hcg(hcg)
    sync_params_buffers(model, hcg.get_sep_parallel_group())
    return model


def broadcast_input_data(hcg, *inputs, **kwargs):
    """reference :168 — give the mp group its source rank's inputs."""
    hcg = _hcg(hcg)
    g = hcg.get_model_parallel_group()
    src = hcg.get_model_parallel_group_src_rank()
    for x in list(inputs) + list(kwargs.values()):
        if isinstance(x, (Tensor, torch.Tensor)):
            C.broadcast(x, src=src, group=g)
    if kwargs:
        return inputs, kwargs
    return inputs if len(inputs) > 1 else inputs[0]


def _leaf(p) -> torch.Tensor:
    return p._data if isinstance(p, Tensor) else p


def allreduce_gradients(params: Iterable, group):
    """Average each parameter's gradient over ``group``, in flat buckets
    of one dtype and device, every bucket launched before the first
    wait."""
    if group is None or group.nranks == 1:
        return
    grads = [_leaf(p).grad for p in params if _leaf(p).grad is not None]
    size = COMM_BUFFER_SIZE * MB
    pending = [(b, *launch_mean(b, group))
               for b in build_buckets(grads, size, size)]
    for b, flat, task in pending:
        write_back(b, flat, task)


def fused_allreduce_gradients(parameter_list, hcg=None):
    """reference :241 — average the gradients over the data-parallel group
    (dp, with the sharding axis: the ranks that see different data)."""
    hcg = _hcg(hcg)
    group = (hcg.get_data_sharding_parallel_group()
             if hcg.get_sharding_parallel_world_size() > 1
             else hcg.get_data_parallel_group())
    allreduce_gradients(parameter_list, group)
