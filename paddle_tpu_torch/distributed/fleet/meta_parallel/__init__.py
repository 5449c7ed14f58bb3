from .parallel_wrappers import ShardingParallel, TensorParallel

__all__ = ["TensorParallel", "ShardingParallel"]
