"""Neural-network functionals, layers, initializers, gradient clipping,
seq2seq decoding, ``utils``, ``lazy_init`` and ``quant`` of the PyTorch
port (counterpart of ``paddle_tpu/nn/``). The layers are the Paddle-API
``Layer``s; the ``torch.nn`` modules of the torch-level models are
``TorchLinear``, ``TorchLayerNorm`` and ``TorchRMSNorm``."""
from . import functional, initializer, lazy_init, quant, utils
from . import functional as F  # noqa: F401
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .decode import BeamSearchDecoder, Decoder, dynamic_decode
from .layer import *  # noqa: F401,F403
from .layer import (activation, common, container, conv, layers, loss,
                    norm, pooling, rnn, tail, transformer)
from .layer import __all__ as _layers
from .initializer import Constant, Normal, Uniform, XavierNormal  # noqa: F401
from .parameter import Parameter, ParamAttr, create_parameter
from .utils import (clip_grad_norm_, clip_grad_value_, parameters_to_vector,
                    vector_to_parameters)

__all__ = ["functional", "initializer", "lazy_init", "quant", "utils",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Parameter", "ParamAttr", "create_parameter", "BeamSearchDecoder",
           "Decoder", "dynamic_decode", "clip_grad_norm_", "clip_grad_value_",
           "parameters_to_vector", "vector_to_parameters"] + list(_layers)
