"""Device, dtype, RNG and flag helpers of the PyTorch port."""
from .dtype import convert_dtype, dtype_name
from .flags import define_flag, get_flag, on_change, set_flags
from .generator import get_rng_state, make_generator, set_rng_state
from .place import resolve_device

__all__ = ["convert_dtype", "dtype_name", "make_generator", "get_rng_state",
           "set_rng_state", "resolve_device",
           "define_flag", "get_flag", "on_change", "set_flags"]
