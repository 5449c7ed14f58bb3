"""``paddle.hapi`` of the port (counterpart of ``paddle_tpu/hapi``): the
``Model`` facade and its callbacks. ``ModelCheckpoint`` and ``summary``
are still to port (ROADMAP)."""
from . import callbacks
from .callbacks import Callback, EarlyStopping, LRScheduler, ReduceLROnPlateau
from .model import Model

__all__ = ["Model", "callbacks", "Callback", "EarlyStopping", "LRScheduler",
           "ReduceLROnPlateau"]
