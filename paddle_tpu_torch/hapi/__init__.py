"""``paddle.hapi`` of the port (counterpart of ``paddle_tpu/hapi``): the
``Model`` facade, its callbacks, ``summary`` and ``flops``."""
from . import callbacks
from .callbacks import (Callback, EarlyStopping, LRScheduler,
                        ModelCheckpoint, ReduceLROnPlateau)
from .dynamic_flops import flops
from .model import Model
from .summary import summary

__all__ = ["Model", "summary", "flops", "callbacks", "Callback",
           "EarlyStopping", "LRScheduler", "ModelCheckpoint",
           "ReduceLROnPlateau"]
