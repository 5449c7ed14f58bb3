"""Neural-network functionals of the PyTorch port."""
from . import functional

__all__ = ["functional"]
