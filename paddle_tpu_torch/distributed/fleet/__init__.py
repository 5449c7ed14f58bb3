"""Fleet (counterpart of ``paddle_tpu/distributed/fleet/``): the hybrid
topology, the facade (collective mode), the tensor-parallel layers and
RNG streams, the TP and sharding wrappers, the hybrid and ZeRO-1
optimizers, and ``recompute``; ``moe`` (MoE on one process) is imported
by ``incubate.nn``. Pipeline, sequence and sep parallelism, expert
parallelism and the parameter server are later slices."""
from . import utils
from .base.distributed_strategy import DistributedStrategy
from .base.topology import (CommunicateTopology, HybridCommunicateGroup,
                            ParallelMode, get_hybrid_communicate_group)
from .fleet_base import Fleet, fleet
from .meta_optimizers import (DygraphShardingOptimizer,
                              HybridParallelClipGrad,
                              HybridParallelOptimizer)
from .meta_parallel import ShardingParallel, TensorParallel
from .mpu import (ColumnParallelLinear, ParallelCrossEntropy,
                  RowParallelLinear, VocabParallelEmbedding,
                  get_rng_state_tracker, model_parallel_random_seed, mp_ops)
from .recompute import recompute, recompute_sequential

# facade functions bound to the singleton (reference fleet.py module tail)
init = fleet.init
distributed_model = fleet.distributed_model
distributed_optimizer = fleet.distributed_optimizer
collective_perf = fleet.collective_perf
worker_num = fleet.worker_num
worker_index = fleet.worker_index
barrier_worker = fleet.barrier_worker
get_hybrid_communicate_group = fleet.get_hybrid_communicate_group

__all__ = [
    "Fleet", "fleet", "init", "distributed_model", "distributed_optimizer",
    "collective_perf", "worker_num", "worker_index", "barrier_worker",
    "DistributedStrategy", "CommunicateTopology", "HybridCommunicateGroup",
    "ParallelMode", "get_hybrid_communicate_group",
    "DygraphShardingOptimizer", "HybridParallelOptimizer",
    "HybridParallelClipGrad", "TensorParallel", "ShardingParallel",
    "ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
    "ParallelCrossEntropy", "get_rng_state_tracker",
    "model_parallel_random_seed", "mp_ops", "recompute",
    "recompute_sequential",
]
