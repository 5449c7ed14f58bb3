"""Program capture of the port: ``to_static`` (the op-stream recorder for
Paddle-API callables, ``torch.fx`` for ``torch.nn.Module``s) with the
graph-fusion pass, and ``TracedLayer``. ``save``/``load`` and
``TranslatedLayer``, ``donating_jit`` and SOT wait for later slices."""
from .api import (StaticFunction, ignore_module, in_capture_mode,
                  not_to_static, to_static)
from .traced_layer import TracedLayer

__all__ = ["StaticFunction", "to_static", "not_to_static", "in_capture_mode",
           "ignore_module", "TracedLayer"]
