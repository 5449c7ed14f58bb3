"""Neural-network functionals, layers and gradient clipping of the PyTorch
port."""
from . import functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import LayerNorm, Linear, RMSNorm

__all__ = ["functional", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "Linear", "LayerNorm", "RMSNorm"]
