"""``paddle.vision`` of the port (counterpart of ``paddle_tpu/vision``):
``models`` with the ResNet family. Transforms, datasets, image I/O and
the vision ops are still to port (ROADMAP)."""
from . import models

__all__ = ["models"]
