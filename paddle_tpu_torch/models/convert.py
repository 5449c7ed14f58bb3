"""Carry weights from the JAX package's models into the port's.

The input is the JAX model's ``state_dict()`` as numpy arrays (keys are
the same dotted attribute paths in both packages). Into a torch-level
model (``load_jax_state``): Paddle's ``Linear`` stores its weight as (in,
out), ``torch.nn.Linear`` as (out, in), so those are transposed, and
everything else is copied as it is. A tensor-parallel model (the
``distributed.fleet.mpu`` twins: the JAX model's arrays are the full,
logical ones) takes this rank's part of each split parameter, as the
layer's ``mp_splits`` cuts it: a fused q/k/v projection by thirds first,
so that rank r gets the q, k and v columns of its heads. Into a
Paddle-API ``Layer`` (``load_jax_layer_state``) every key and layout is
already the JAX package's: it is ``set_state_dict``. Into a
``static.Program`` (``load_jax_program_state``): the JAX program's
persistable captured tensors, in recording order, onto the port
program's, whose layer helpers made the same parameters in the same order.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn


def load_jax_state(model: nn.Module, arrays: Dict[str, np.ndarray],
                   strict: bool = True, mp_rank: Optional[int] = None,
                   mp_degree: Optional[int] = None) -> nn.Module:
    """Copy ``arrays`` into ``model``'s parameters and buffers in place,
    in the model's dtype and device. With ``strict``, raise ``KeyError``
    on missing or unexpected keys; a shape mismatch always raises
    ``ValueError``. A tensor-parallel model takes rank ``mp_rank``'s part
    of ``mp_degree`` (default: its layers' own rank and degree) of each
    split parameter."""
    from ..distributed.fleet.mpu.mp_layers import (
        TorchColumnParallelLinear, TorchRowParallelLinear, _TorchParallel,
        shard)
    linear_weights = {f"{name}.weight" for name, mod in model.named_modules()
                      if isinstance(mod, (nn.Linear, TorchColumnParallelLinear,
                                          TorchRowParallelLinear))}
    splits = {}
    for name, mod in model.named_modules():
        if isinstance(mod, _TorchParallel):
            rank = mod.mp_rank if mp_rank is None else mp_rank
            degree = mod.mp_degree if mp_degree is None else mp_degree
            for pname, (dim, groups) in mod.mp_splits().items():
                splits[f"{name}.{pname}"] = (dim, rank, degree, groups)
    own = model.state_dict()
    missing = sorted(set(own) - set(arrays))
    unexpected = sorted(set(arrays) - set(own))
    if strict and (missing or unexpected):
        raise KeyError(f"load_jax_state: missing keys {missing}, "
                       f"unexpected keys {unexpected}")
    with torch.no_grad():
        for key, target in own.items():
            if key not in arrays:
                continue
            value = np.asarray(arrays[key])
            if key in linear_weights:
                value = value.T
            if key in splits:
                dim, rank, degree, groups = splits[key]
                value = shard(value, dim, rank, degree, groups)
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(
                    f"load_jax_state: {key} has shape {value.shape}, the "
                    f"model wants {tuple(target.shape)}")
            target.copy_(torch.from_numpy(np.ascontiguousarray(value)))
    return model


def load_jax_layer_state(layer, arrays: Dict[str, np.ndarray]):
    """``layer.set_state_dict(arrays)`` for a Paddle-API ``Layer``, raising
    ``KeyError`` on missing or unexpected keys. Every layer of the port's
    ``nn`` and ``incubate.nn`` keeps the JAX package's names and layouts
    (an RNN stack's ``cells.<layer * directions + d>.weight_ih``, the
    Transformer's, the fused layers'), so none needs a mapping."""
    missing, unexpected = layer.set_state_dict(arrays)
    if missing or unexpected:
        raise KeyError(f"load_jax_layer_state: missing keys {missing}, "
                       f"unexpected keys {unexpected}")
    return layer


def load_jax_program_state(program, arrays: Sequence[np.ndarray]):
    """Copy ``arrays`` (a JAX ``static.Program``'s persistable captured
    tensors as numpy, in recording order) into the port ``program``'s
    persistable captured tensors, in its recording order. Raises
    ``ValueError`` on another count or shape. Returns the program."""
    params = [t for t in program._captured.values()
              if getattr(t, "persistable", False)]
    arrays = list(arrays)
    if len(arrays) != len(params):
        raise ValueError(f"load_jax_program_state: {len(arrays)} arrays for "
                         f"{len(params)} persistable tensors")
    for k, (t, a) in enumerate(zip(params, arrays)):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(
                f"load_jax_program_state: array {k} has shape {a.shape}, "
                f"{t.name!r} wants {tuple(t.shape)}")
        t.set_value(torch.from_numpy(np.array(a)))
    return program
