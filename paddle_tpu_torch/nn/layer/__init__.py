"""Layers of the port: the Paddle-API ``Layer``s (as in the JAX
package's ``nn/layer/``) and, in ``torch_modules``, the ``torch.nn``
modules the torch-level GPT-2 and LLaMA are built from."""
from .layers import Layer
from .activation import *  # noqa: F401,F403
from .common import *      # noqa: F401,F403
from .container import LayerDict, LayerList, ParameterList, Sequential
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                   Conv3DTranspose)
from .loss import *        # noqa: F401,F403
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   GroupNorm, InstanceNorm1D, InstanceNorm2D, InstanceNorm3D,
                   LayerNorm, LocalResponseNorm, RMSNorm, SpectralNorm,
                   SyncBatchNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
                      AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D,
                      AvgPool1D, AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D,
                      MaxPool3D)
from .rnn import (RNN, GRU, LSTM, BiRNN, GRUCell, LSTMCell, RNNCellBase,
                  SimpleRNN, SimpleRNNCell)
from .tail import *        # noqa: F401,F403
from .torch_modules import TorchLayerNorm, TorchLinear, TorchRMSNorm
from .transformer import (MultiHeadAttention, Transformer, TransformerDecoder,
                          TransformerDecoderLayer, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = sorted(n for n, v in list(globals().items())
                 if isinstance(v, type) and issubclass(v, Layer)) + [
    "TorchLayerNorm", "TorchLinear", "TorchRMSNorm"]
