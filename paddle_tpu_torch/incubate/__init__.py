"""paddle.incubate (counterpart of ``paddle_tpu/incubate/``): the
functional autograd surface and ``incubate.nn``; ``asp`` is still to
port."""
from . import autograd, nn

__all__ = ["autograd", "nn"]
