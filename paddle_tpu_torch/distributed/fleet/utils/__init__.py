from ..recompute import recompute, recompute_sequential
from .hybrid_parallel_util import (broadcast_dp_parameters,
                                   broadcast_input_data,
                                   broadcast_mp_parameters,
                                   broadcast_sep_parameters,
                                   broadcast_sharding_parameters,
                                   fused_allreduce_gradients)

__all__ = ["broadcast_dp_parameters", "broadcast_mp_parameters",
           "broadcast_sep_parameters", "broadcast_sharding_parameters",
           "broadcast_input_data", "fused_allreduce_gradients",
           "recompute", "recompute_sequential"]
