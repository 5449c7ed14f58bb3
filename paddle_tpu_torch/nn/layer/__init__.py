"""Layers of the port: ``torch.nn`` layers routed through the port's
functionals, and those ``torch.nn`` does not have."""
from .common import Linear
from .norm import LayerNorm, RMSNorm

__all__ = ["Linear", "LayerNorm", "RMSNorm"]
