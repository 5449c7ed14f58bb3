"""Fleet (counterpart of ``paddle_tpu/distributed/fleet/``). Ported so
far: ``recompute`` and ``recompute_sequential``."""
from .recompute import recompute, recompute_sequential

__all__ = ["recompute", "recompute_sequential"]
