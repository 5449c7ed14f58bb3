"""``paddle.vision`` of the port (counterpart of ``paddle_tpu/vision``):
``models`` (the whole zoo), ``ops`` (detection and vision ops),
``transforms``, ``datasets`` and the image backend functions."""
from . import datasets, models, ops, transforms
from .image import get_image_backend, image_load, set_image_backend

__all__ = ["models", "ops", "transforms", "datasets",
           "set_image_backend", "get_image_backend", "image_load"]
