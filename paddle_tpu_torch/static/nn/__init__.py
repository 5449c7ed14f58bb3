"""static.nn: the in-graph control flow (counterpart of
``paddle_tpu/static/nn``'s ``cond``, ``while_loop``, ``case`` and
``switch_case``). ``static.nn.common`` waits for ``static.Program``.
"""
from .control_flow import case, cond, switch_case, while_loop

__all__ = ["cond", "while_loop", "case", "switch_case"]
