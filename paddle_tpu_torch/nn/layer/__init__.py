"""Layers of the port that ``torch.nn`` does not have."""
from .norm import RMSNorm

__all__ = ["RMSNorm"]
