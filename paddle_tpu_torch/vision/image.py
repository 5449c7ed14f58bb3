"""The image backend (counterpart of ``paddle_tpu/vision/image.py``):
``set_image_backend``, ``get_image_backend`` and ``image_load`` with the
"pil", "cv2" and "tensor" backends; Pillow and opencv are imported only
when a load needs them."""
from __future__ import annotations

__all__ = ["set_image_backend", "get_image_backend", "image_load"]

_image_backend = "pil"


def set_image_backend(backend: str) -> None:
    global _image_backend
    if backend not in ("pil", "cv2", "tensor"):
        raise ValueError(
            f"Expected backend are one of ['pil', 'cv2', 'tensor'], but "
            f"got {backend}")
    _image_backend = backend


def get_image_backend() -> str:
    return _image_backend


def image_load(path: str, backend: str | None = None):
    """Load an image with the selected backend: a PIL image ("pil"), a
    BGR array ("cv2", needs opencv), or a Tensor of the pixels
    ("tensor")."""
    backend = backend or _image_backend
    if backend not in ("pil", "cv2", "tensor"):
        raise ValueError(
            f"Expected backend are one of ['pil', 'cv2', 'tensor'], but "
            f"got {backend}")
    if backend == "cv2":
        try:
            import cv2
        except ImportError:
            raise ImportError(
                "backend 'cv2' requires opencv-python, which is not "
                "installed; use the 'pil' backend")
        return cv2.imread(path)
    from PIL import Image
    img = Image.open(path)
    if backend == "tensor":
        import numpy as np

        from ..core.tensor import as_tensor
        return as_tensor(np.asarray(img))
    return img
