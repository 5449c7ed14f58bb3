"""Meta-parallel model wrappers (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/parallel_wrappers.py``;
reference fleet/meta_parallel/tensor_parallel.py, sharding_parallel.py).

The JAX wrappers place one global batch on the mesh. The port's ranks
each take their own batch (the ranks of one mp group the same one), as
the reference's do, so a wrapper calls the model as it is; at wrap time
it broadcasts the parameters from the source ranks, as the reference
does, so every copy starts equal. The gradients are averaged over the
data-parallel ranks by ``HybridParallelOptimizer.step``.
"""
from __future__ import annotations

from ...parallel import _ParallelWrapper
from ..utils.hybrid_parallel_util import (broadcast_dp_parameters,
                                          broadcast_mp_parameters,
                                          broadcast_sharding_parameters)


class _HybridWrapper(_ParallelWrapper):
    def __init__(self, layers, hcg, strategy=None):
        super().__init__(layers)
        self._hcg = hcg
        self._strategy = strategy


class TensorParallel(_HybridWrapper):
    """reference meta_parallel/tensor_parallel.py: the parameters not
    split over mp from the mp group's source rank, then every parameter
    from the dp (and sharding) source rank."""

    def __init__(self, layers, hcg, strategy=None):
        super().__init__(layers, hcg, strategy)
        broadcast_mp_parameters(layers, hcg)
        broadcast_dp_parameters(layers, hcg)
        if hcg.get_sharding_parallel_world_size() > 1:
            broadcast_sharding_parameters(layers, hcg)


class ShardingParallel(_HybridWrapper):
    """reference meta_parallel/sharding_parallel.py: every parameter from
    the sharding and the dp source ranks."""

    def __init__(self, layers, hcg, strategy=None):
        super().__init__(layers, hcg, strategy)
        broadcast_sharding_parameters(layers, hcg)
        broadcast_dp_parameters(layers, hcg)
