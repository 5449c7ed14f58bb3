"""Compile-time passes of the port: the graph-fusion pass (``fusion``)."""
from . import fusion

__all__ = ["fusion"]
