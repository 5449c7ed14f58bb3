"""Neural-network functionals, layers, initializers and gradient clipping
of the PyTorch port (counterpart of ``paddle_tpu/nn/``). The layers
are the Paddle-API ``Layer``s; the ``torch.nn`` modules of the
torch-level models are ``TorchLinear``, ``TorchLayerNorm`` and
``TorchRMSNorm``."""
from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layers
from .parameter import Parameter, ParamAttr, create_parameter

__all__ = ["functional", "initializer", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "Parameter", "ParamAttr",
           "create_parameter"] + list(_layers)
