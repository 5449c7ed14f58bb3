"""Functionals of the port (counterpart of
``paddle_tpu/nn/functional/``): the whole surface of the JAX package.

The entries that existed before the Paddle API (``linear``,
``dropout``, ``embedding``, ``cross_entropy``,
``fused_linear_cross_entropy``, ``scaled_dot_product_attention``,
``flash_attention``, ``matmul``, the norms, the activations the
torch-level models use, the fused ops, the convolutions and pools) take
Paddle ``Tensor``s through the op dispatcher, and the same functions
take ``torch.Tensor``s as the torch-level functionals of the port's
models and fusion pass; each module's docstring says where a layout
differs (the weights of ``linear``, ``fused_norm_linear`` and
``fused_rope_proj``). The rest run one body over either kind of input
(``_op.call``).

Every functional is in ``ops.registry`` under the JAX package's name and
category (``_register``, as the JAX package's ``ops._register_all``)."""
from .activation import *  # noqa: F401,F403
from .common import *      # noqa: F401,F403
from .conv import *        # noqa: F401,F403
from .pooling import *     # noqa: F401,F403
from .norm import *        # noqa: F401,F403
from .loss import *        # noqa: F401,F403
from .flash_attention import *  # noqa: F401,F403
from .vision import *      # noqa: F401,F403
from .paged_attention import *  # noqa: F401,F403
from .fused import *       # noqa: F401,F403
from .tail import *        # noqa: F401,F403
from ...ops.search import class_center_sample, gather_tree  # noqa: F401

from . import (activation, common, conv, flash_attention, fused, loss,
               norm, paged_attention, pooling, tail, vision)
from .fused import ACTIVATIONS, FUSED_OPS  # noqa: F401


def _register():
    import sys

    from ...ops.registry import register, register_module

    def mod(name):      # a submodule (``flash_attention`` is also a function)
        return sys.modules[f"{__name__}.{name}"]
    for name, cat, skip in (("activation", "activation", ("sigmoid", "tanh")),
                            ("common", "nn_common", ("one_hot", "pad",
                                                     "unfold")),
                            ("conv", "conv", ()), ("loss", "loss", ()),
                            ("norm", "norm", ()), ("pooling", "pooling", ()),
                            ("flash_attention", "attention", ()),
                            ("vision", "vision", ()),
                            ("paged_attention", "attention", ())):
        register_module(mod(name), cat, skip=skip)
    # the JAX package registers these at the ops level
    for name, cat in (("pad", "manipulation"), ("unfold", "manipulation"),
                      ("tanh_", "inplace")):
        register(name, cat)(getattr(mod("common" if cat != "inplace"
                                        else "tail"), name))


_register()
