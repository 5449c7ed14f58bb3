"""Layers of the port: the Paddle-API ``Layer``s (as in the JAX
package's ``nn/layer/``) and, in ``torch_modules``, the ``torch.nn``
modules the torch-level GPT-2 and LLaMA are built from."""
from .activation import GELU, ReLU, Sigmoid, Silu, Softmax, Tanh
from .common import Dropout, Embedding, Flatten, Identity, Linear
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                   Conv3DTranspose)
from .container import LayerDict, LayerList, ParameterList, Sequential
from .layers import Layer
from .loss import CrossEntropyLoss
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
                      AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D,
                      AvgPool1D, AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D,
                      MaxPool3D)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   LayerNorm, RMSNorm)
from .torch_modules import TorchLayerNorm, TorchLinear, TorchRMSNorm
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["Layer", "Sequential", "LayerList", "LayerDict", "ParameterList",
           "Linear", "Embedding", "Dropout", "Identity", "Flatten",
           "LayerNorm", "RMSNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "ReLU", "GELU", "Tanh", "Sigmoid", "Silu",
           "Softmax", "CrossEntropyLoss", "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder", "TorchLinear",
           "TorchLayerNorm", "TorchRMSNorm", "Conv1D", "Conv2D", "Conv3D",
           "Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D"]
