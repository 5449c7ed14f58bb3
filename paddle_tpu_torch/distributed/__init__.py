"""Distributed training (counterpart of ``paddle_tpu/distributed/``), on
``torch.distributed``: NCCL on the cards, gloo when the caller set the CPU.

Ported: process groups, the collectives, the process mesh, the launcher
(``python -m paddle_tpu_torch.distributed.launch``), ``init_parallel_env``
and ``DataParallel`` with its own reducer, and ``fleet`` (the hybrid
topology, the facade, the tensor-parallel layers and RNG streams, the TP
and sharding wrappers, the hybrid and ZeRO-1 optimizers, ``recompute``),
and the progress ``watchdog``. The JAX package is single-controller; the
port is one process a card: rank r's local tensor is shard r of the JAX
global array (ROADMAP Queue 3)."""
from . import fleet, launch, mesh, watchdog
from .communication.collective import (P2POp, ReduceOp, all_gather,
                                       all_gather_object, all_reduce,
                                       all_to_all, alltoall, alltoall_single,
                                       barrier, batch_isend_irecv, broadcast,
                                       broadcast_object_list, irecv, isend,
                                       recv, reduce, reduce_scatter, scatter,
                                       send, shift_along_axis)
from .communication.group import (Group, destroy_process_group,
                                  get_default_group, get_group,
                                  is_initialized, new_group)
from .fleet.mpu.mp_ops import split
from .mesh import build_mesh, get_mesh, set_mesh
from .parallel import (DataParallel, ParallelEnv, get_rank, get_world_size,
                       init_parallel_env)

__all__ = [
    "fleet", "launch", "mesh", "watchdog", "build_mesh", "get_mesh",
    "set_mesh", "Group", "destroy_process_group", "get_default_group",
    "get_group", "is_initialized", "new_group", "P2POp", "ReduceOp",
    "all_gather", "all_gather_object", "all_reduce", "all_to_all",
    "alltoall", "alltoall_single", "barrier", "batch_isend_irecv",
    "broadcast", "broadcast_object_list", "irecv", "isend", "recv", "reduce",
    "reduce_scatter", "scatter", "send", "shift_along_axis", "split",
    "DataParallel", "ParallelEnv", "get_rank", "get_world_size",
    "init_parallel_env",
]
