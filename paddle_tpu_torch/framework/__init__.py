"""``paddle.framework`` of the port (counterpart of
``paddle_tpu/framework/__init__.py``): ``save``/``load`` (the JAX
package's v2 checkpoint files, :mod:`.io`), the RNG state helpers and the
mode queries."""
from ..core.dispatch import grad_enabled
from ..core.generator import get_rng_state, seed, set_rng_state
from .io import CheckpointCorruptError, load, save
from .random import get_cuda_rng_state, set_cuda_rng_state

__all__ = ["save", "load", "CheckpointCorruptError", "grad_enabled",
           "get_rng_state", "set_rng_state", "seed", "get_cuda_rng_state",
           "set_cuda_rng_state", "in_dynamic_mode", "in_pir_mode",
           "use_pir_api"]


def in_dynamic_mode():
    """False while ``jit.to_static`` traces the program (``torch.fx``)."""
    from torch.fx._symbolic_trace import is_fx_tracing
    return not is_fx_tracing()


def in_pir_mode():
    return False


def use_pir_api():
    return False
