"""static.nn: the layer helpers of construct-then-execute code
(``common``) and the in-graph control flow (``control_flow``: ``cond``,
``while_loop``, ``case``, ``switch_case``), the counterpart of
``paddle_tpu/static/nn``.
"""
from . import common, control_flow  # noqa: F401
from .common import *  # noqa: F401,F403
from .common import __all__ as _common_all
from .control_flow import case, cond, switch_case, while_loop

__all__ = list(_common_all) + ["cond", "while_loop", "case", "switch_case"]


def __getattr__(name):
    # as the JAX package's: an unknown name is read from the common module
    return getattr(common, name)
