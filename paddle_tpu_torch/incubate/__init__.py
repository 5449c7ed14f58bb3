"""paddle.incubate (counterpart of ``paddle_tpu/incubate/``): the
functional autograd surface so far."""
from . import autograd

__all__ = ["autograd"]
