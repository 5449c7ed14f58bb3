"""Device, dtype and RNG helpers of the PyTorch port."""
from .dtype import convert_dtype, dtype_name
from .generator import make_generator
from .place import resolve_device

__all__ = ["convert_dtype", "dtype_name", "make_generator", "resolve_device"]
