"""Serving of the PyTorch port, under the JAX package's names."""
from .resilience import (Overloaded, ReplicaLifecycle, ReplicaState,
                         RequestOutcome, RequestStatus, ResilienceConfig)
from .serving import (BlockManager, GPTPagedEngine, LlamaPagedEngine,
                      PagedEngine, Request)

__all__ = ["BlockManager", "Request", "PagedEngine", "LlamaPagedEngine",
           "GPTPagedEngine", "Overloaded", "ReplicaLifecycle",
           "ReplicaState", "RequestOutcome", "RequestStatus",
           "ResilienceConfig"]
