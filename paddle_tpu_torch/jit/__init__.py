"""Program capture and deployment of the port: ``to_static`` (the
op-stream recorder for Paddle-API callables, with SOT partial-frame
capture (``jit.sot``) for a signature that breaks; ``torch.fx`` for
``torch.nn.Module``s) with the graph-fusion pass, ``TracedLayer``, and
``save``/``load``/``TranslatedLayer`` (a ``torch.export`` program beside
its parameters, run without the model class). ``donating_jit`` and the
persistent compile cache wait for later slices."""
from . import sot
from .api import (ArtifactVersionError, StaticFunction, TranslatedLayer,
                  ignore_module, in_capture_mode, load, not_to_static, save,
                  to_static)
from .traced_layer import TracedLayer

__all__ = ["sot", "StaticFunction", "to_static", "not_to_static",
           "in_capture_mode", "ignore_module", "TracedLayer", "save", "load", "TranslatedLayer",
           "ArtifactVersionError"]
