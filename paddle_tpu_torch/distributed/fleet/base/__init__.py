from .distributed_strategy import DistributedStrategy
from .topology import (CommunicateTopology, HybridCommunicateGroup,
                       ParallelMode, get_hybrid_communicate_group)

__all__ = ["DistributedStrategy", "CommunicateTopology",
           "HybridCommunicateGroup", "ParallelMode",
           "get_hybrid_communicate_group"]
