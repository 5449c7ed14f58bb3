"""The launcher: ``python -m paddle_tpu_torch.distributed.launch``
(counterpart of ``paddle_tpu/distributed/launch/``)."""
from .main import launch

__all__ = ["launch"]
