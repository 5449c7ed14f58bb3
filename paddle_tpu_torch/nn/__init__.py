"""Neural-network functionals, layers and gradient clipping of the PyTorch
port."""
from . import functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import RMSNorm

__all__ = ["functional", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "RMSNorm"]
