"""Automatic mixed precision (counterpart of ``paddle_tpu/amp/``).

``auto_cast`` O1/O2 with the JAX package's op lists (``amp_lists``),
applied by the op dispatcher and the port's torch-level functionals
through ``amp_cast`` alike on the CPU and the card; ``decorate`` for O2
(a ``torch.nn.Module`` or a Paddle-API ``Layer``); the fp16
``GradScaler``. The JAX package's ``amp.debugging`` is still to port
(it stands on the dispatcher's ``check_nan_inf``, which the port now
has).
"""
from .amp_lists import AMP_BLACK_OPS, AMP_WHITE_OPS
from .auto_cast import amp_decorate, amp_guard, auto_cast, decorate
from .grad_scaler import AmpScaler, GradScaler
from .state import amp_cast, amp_state


def is_float16_supported(device=None):
    """True: an H100 computes fp16 on its tensor cores."""
    return True


def is_bfloat16_supported(device=None):
    """True: an H100 computes bf16 on its tensor cores."""
    return True


__all__ = ["auto_cast", "amp_guard", "decorate", "amp_decorate",
           "GradScaler", "AmpScaler", "amp_cast", "amp_state",
           "AMP_WHITE_OPS", "AMP_BLACK_OPS", "is_float16_supported",
           "is_bfloat16_supported"]
