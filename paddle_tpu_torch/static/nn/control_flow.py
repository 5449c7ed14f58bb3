"""``static.nn`` control flow: the ops of ``paddle_tpu_torch.ops.
control_flow`` (the JAX package's module re-exports its ops the same
way)."""
from ...ops.control_flow import case, cond, switch_case, while_loop

__all__ = ["cond", "while_loop", "case", "switch_case"]
