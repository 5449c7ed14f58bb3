"""Program capture of the port: ``to_static`` (``torch.fx``) with the
graph-fusion pass."""
from .api import StaticFunction, to_static

__all__ = ["StaticFunction", "to_static"]
