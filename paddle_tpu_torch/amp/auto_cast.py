"""``auto_cast`` and ``decorate`` (counterpart of
``paddle_tpu/amp/auto_cast.py``)."""
from __future__ import annotations

from torch import nn
from torch.nn.modules.batchnorm import _BatchNorm

from ..core.dtype import convert_dtype
from .state import restore_amp_state, set_amp_state


class auto_cast:
    """Context manager: under O1 (and O2) the port's functionals cast a
    white-list op's inputs to ``dtype`` and a black-list op's to fp32
    (``amp_lists``; ``custom_white_list``/``custom_black_list`` add
    names). O2 expects the parameters cast by ``decorate``."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16",
                 use_promote=True):
        if level not in ("O0", "O1", "O2", "OD"):
            raise ValueError(f"unsupported amp level {level}")
        self.level = level if enable else "O0"
        self.dtype = dtype
        self.custom_white_list = custom_white_list
        self.custom_black_list = custom_black_list

    def __enter__(self):
        self._prev = set_amp_state(self.level, self.dtype,
                                   self.custom_white_list,
                                   self.custom_black_list)
        return self

    def __exit__(self, *exc):
        restore_amp_state(self._prev)
        return False


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """O2: cast the models' floating parameters to ``dtype`` in place
    (the same ``Parameter`` objects, so optimizers built on them stay
    valid), except those of LayerNorm and BatchNorm layers and of
    ``excluded_layers`` (layer types); the port's ``RMSNorm`` is cast, as
    the JAX package's is. A model is a ``torch.nn.Module`` or a Paddle-API
    ``Layer`` (whose Parameters keep their payloads, cast in place). Each
    optimizer keeps fp32 masters (``_multi_precision``). O0/O1 return the
    arguments unchanged."""
    if level in ("O0", "O1"):
        return (models, optimizers) if optimizers is not None else models
    target = convert_dtype(dtype)
    model_list = models if isinstance(models, (list, tuple)) else [models]
    from ..nn.layer.layers import Layer
    from ..nn.layer.norm import LayerNorm, _BatchNormBase
    keep = (nn.LayerNorm, _BatchNorm, LayerNorm, _BatchNormBase) + tuple(
        excluded_layers or ())
    for model in model_list:
        if isinstance(model, Layer):
            layers = model.sublayers(include_self=True)
            params = [[p._data for p in layer.parameters(
                include_sublayers=False)] for layer in layers]
        else:
            layers = list(model.modules())
            params = [list(layer.parameters(recurse=False))
                      for layer in layers]
        for layer, ps in zip(layers, params):
            if isinstance(layer, keep):
                continue     # norm layers stay fp32 for numeric stability
            for p in ps:
                if p.is_floating_point():
                    p.data = p.data.to(target)
    out = models if isinstance(models, (list, tuple)) else model_list[0]
    if optimizers is None:
        return out
    for opt in (optimizers if isinstance(optimizers, (list, tuple))
                else [optimizers]):
        opt._multi_precision = True
    return out, optimizers


amp_decorate = decorate

__all__ = ["auto_cast", "amp_guard", "decorate", "amp_decorate"]
