from .dygraph_sharding_optimizer import DygraphShardingOptimizer
from .hybrid_parallel_optimizer import (HybridParallelClipGrad,
                                        HybridParallelOptimizer)

__all__ = ["DygraphShardingOptimizer", "HybridParallelOptimizer",
           "HybridParallelClipGrad"]
