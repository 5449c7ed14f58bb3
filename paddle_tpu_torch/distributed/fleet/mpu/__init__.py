"""Model-parallel unit: TP comm ops, layers and RNG streams
(counterpart of ``paddle_tpu/distributed/fleet/mpu/``)."""
from . import mp_ops
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, TorchColumnParallelLinear,
                        TorchRowParallelLinear, TorchVocabParallelEmbedding,
                        VocabParallelEmbedding, parallel_cross_entropy)
from .random import (RNGStatesTracker, get_rng_state_tracker,
                     model_parallel_random_seed)

__all__ = [
    "mp_ops", "ColumnParallelLinear", "RowParallelLinear",
    "VocabParallelEmbedding", "ParallelCrossEntropy",
    "TorchColumnParallelLinear", "TorchRowParallelLinear",
    "TorchVocabParallelEmbedding", "parallel_cross_entropy",
    "RNGStatesTracker", "get_rng_state_tracker",
    "model_parallel_random_seed",
]
