"""Device, dtype, RNG and flag helpers of the PyTorch port."""
from .dtype import convert_dtype, dtype_name
from .flags import define_flag, get_flag, set_flags
from .generator import make_generator
from .place import resolve_device

__all__ = ["convert_dtype", "dtype_name", "make_generator", "resolve_device",
           "define_flag", "get_flag", "set_flags"]
