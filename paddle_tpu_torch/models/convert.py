"""Carry weights from the JAX package's models into the port's.

The input is the JAX model's ``state_dict()`` as numpy arrays (keys are
the same dotted attribute paths in both packages). Into a torch-level
model (``load_jax_state``): Paddle's ``Linear`` stores its weight as (in,
out), ``torch.nn.Linear`` as (out, in), so those are transposed, and
everything else is copied as it is. Into a Paddle-API ``Layer``
(``load_jax_layer_state``) every key and layout is already the JAX
package's: it is ``set_state_dict``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def load_jax_state(model: nn.Module, arrays: Dict[str, np.ndarray],
                   strict: bool = True) -> nn.Module:
    """Copy ``arrays`` into ``model``'s parameters and buffers in place,
    in the model's dtype and device. With ``strict``, raise ``KeyError``
    on missing or unexpected keys; a shape mismatch always raises
    ``ValueError``."""
    linear_weights = {f"{name}.weight" for name, mod in model.named_modules()
                      if isinstance(mod, nn.Linear)}
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
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(
                    f"load_jax_state: {key} has shape {value.shape}, the "
                    f"model wants {tuple(target.shape)}")
            target.copy_(torch.from_numpy(np.ascontiguousarray(value)))
    return model


def load_jax_layer_state(layer, arrays: Dict[str, np.ndarray]):
    """``layer.set_state_dict(arrays)`` for a Paddle-API ``Layer``, raising
    ``KeyError`` on missing or unexpected keys."""
    missing, unexpected = layer.set_state_dict(arrays)
    if missing or unexpected:
        raise KeyError(f"load_jax_layer_state: missing keys {missing}, "
                       f"unexpected keys {unexpected}")
    return layer
