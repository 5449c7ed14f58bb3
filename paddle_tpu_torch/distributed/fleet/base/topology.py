"""The hybrid-parallel topology (counterpart of
``paddle_tpu/distributed/fleet/base/topology.py``; reference
python/paddle/distributed/fleet/base/topology.py:178).

``CommunicateTopology`` is the JAX package's coordinate bookkeeping, as
it is: world rank = the row-major index of the coordinate over the axes
in their order. ``HybridCommunicateGroup`` is the reference's: this
process's coordinate on each axis, and one process group a line of each
axis (made collectively when it is built, through the process mesh of
the same axes), plus the dp x sharding group the hybrid optimizer
reduces over. The other fused groups (dp x sep, pp x mp, the check
group) are made at their getter's first call, which every rank must
make, in the same order.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from ... import mesh as mesh_mod

# Reference axis order (topology.py hybrid_group_names): data, pipe,
# sharding, sep, model.
AXIS_ORDER = ("dp", "pp", "sharding", "sep", "mp")
_REF_NAMES = {"dp": "data", "pp": "pipe", "sharding": "sharding",
              "sep": "sep", "mp": "model"}
#: the fused group made with the per-axis ones: the ranks that see
#: different data, which the hybrid optimizer reduces gradients over
DATA_AXES = ("dp", "sharding")


class ParallelMode:
    """reference base/topology.py ParallelMode enum."""
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3
    SEGMENT_PARALLEL = 4


class CommunicateTopology:
    """Cartesian rank topology (reference topology.py:60 region)."""

    def __init__(self, hybrid_group_names: Sequence[str] = AXIS_ORDER,
                 dims: Sequence[int] = None):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims) if dims is not None else [1] * len(
            self._parallel_names)
        self._coord_map = {}
        self._rank_map = {}
        for rank, coord in enumerate(np.ndindex(*self._dims)):
            self._coord_map[tuple(coord)] = rank
            self._rank_map[rank] = tuple(coord)

    def get_hybrid_group_names(self) -> List[str]:
        return self._parallel_names

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        return int(np.prod(self._dims))

    def get_rank(self, **kwargs) -> int:
        coord = tuple(kwargs[name] for name in self._parallel_names)
        return self._coord_map[coord]

    def get_coord(self, rank: int) -> Tuple[int, ...]:
        return self._rank_map[rank]

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        """All world ranks whose coordinate on ``axis_name`` equals index."""
        axis = self._parallel_names.index(axis_name)
        return sorted(r for r, c in self._rank_map.items()
                      if c[axis] == index)

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """Rank groups that communicate along ``axis_name`` (one group per
        coordinate of the other axes) — reference get_comm_list."""
        axis = self._parallel_names.index(axis_name)
        other_dims = [d for i, d in enumerate(self._dims) if i != axis]
        groups = []
        for other in np.ndindex(*other_dims):
            ranks = []
            for k in range(self._dims[axis]):
                coord = list(other)
                coord.insert(axis, k)
                ranks.append(self._coord_map[tuple(coord)])
            groups.append(ranks)
        return groups


class HybridCommunicateGroup:
    """This rank's place in the topology and its groups (reference
    topology.py:178). Built after ``init_parallel_env`` it makes the
    process mesh of the topology's axes and every group (collective:
    every rank builds it, in the same order) and becomes the current
    mesh; built before, with ``rank=``, it answers the coordinate queries
    only (its group getters raise)."""

    def __init__(self, topology: CommunicateTopology,
                 rank: Optional[int] = None):
        self._topo = topology
        names = topology.get_hybrid_group_names()
        self._mesh = None
        if dist.is_initialized():
            if topology.world_size() != dist.get_world_size():
                raise ValueError(
                    f"the topology has {topology.world_size()} ranks, the "
                    f"world {dist.get_world_size()}")
            self._mesh = mesh_mod.build_mesh(
                {n: topology.get_dim(n) for n in names})
            self._mesh.group(DATA_AXES)
            mesh_mod.set_mesh(self._mesh)
            rank = dist.get_rank() if rank is None else rank
        elif rank is None:
            raise ValueError("HybridCommunicateGroup: pass rank= before "
                             "init_parallel_env()")
        self.global_rank = int(rank)
        self.nranks = topology.world_size()
        self._coord = dict(zip(names, topology.get_coord(self.global_rank)))
        self._dp_degree = self._axis_size("dp")
        self._mp_degree = self._axis_size("mp")
        self._pp_degree = self._axis_size("pp")
        self._sharding_degree = self._axis_size("sharding")
        self._sep_degree = self._axis_size("sep")

    # ------------------------------------------------------------- helpers
    def _axis_size(self, axis: str) -> int:
        names = self._topo.get_hybrid_group_names()
        return self._topo.get_dim(axis) if axis in names else 1

    def _axis_rank(self, axis: str) -> int:
        return self._coord.get(axis, 0)

    def _group(self, *axes):
        if self._mesh is None:
            raise RuntimeError("HybridCommunicateGroup: no groups before "
                               "init_parallel_env()")
        return self._mesh.group(axes)

    def _src(self, *axes) -> int:
        """The first global rank of this rank's group over ``axes``."""
        names = self._topo.get_hybrid_group_names()
        coord = {n: (0 if n in axes else self._coord[n]) for n in names}
        return self._topo.get_rank(**coord)

    def topology(self) -> CommunicateTopology:
        return self._topo

    @property
    def mesh(self):
        return self._mesh

    def get_global_rank(self) -> int:
        return self.global_rank

    def get_parallel_mode(self) -> int:
        # reference topology.py:233 region — precedence pp > sharding > mp
        # > sep > dp
        if self._pp_degree > 1:
            return ParallelMode.PIPELINE_PARALLEL
        if self._sharding_degree > 1:
            return ParallelMode.SHARDING_PARALLEL
        if self._mp_degree > 1:
            return ParallelMode.TENSOR_PARALLEL
        if self._sep_degree > 1:
            return ParallelMode.SEGMENT_PARALLEL
        return ParallelMode.DATA_PARALLEL

    # ----------------------------------------------------- per-axis queries
    def get_data_parallel_world_size(self) -> int:
        return self._dp_degree

    def get_data_parallel_rank(self) -> int:
        return self._axis_rank("dp")

    def get_data_parallel_group(self):
        return self._group("dp")

    def get_data_parallel_group_src_rank(self) -> int:
        return self._src("dp")

    def get_model_parallel_world_size(self) -> int:
        return self._mp_degree

    def get_model_parallel_rank(self) -> int:
        return self._axis_rank("mp")

    def get_model_parallel_group(self):
        return self._group("mp")

    def get_model_parallel_group_src_rank(self) -> int:
        return self._src("mp")

    def get_pipe_parallel_world_size(self) -> int:
        return self._pp_degree

    def get_stage_id(self) -> int:
        return self._axis_rank("pp")

    def get_pipe_parallel_rank(self) -> int:
        return self._axis_rank("pp")

    def get_pipe_parallel_group(self):
        return self._group("pp")

    def is_first_stage(self) -> bool:
        return self.get_stage_id() == 0

    def is_last_stage(self) -> bool:
        return self.get_stage_id() == self._pp_degree - 1

    def get_sharding_parallel_world_size(self) -> int:
        return self._sharding_degree

    def get_sharding_parallel_rank(self) -> int:
        return self._axis_rank("sharding")

    def get_sharding_parallel_group(self):
        return self._group("sharding")

    def get_sharding_parallel_group_src_rank(self) -> int:
        return self._src("sharding")

    def get_sep_parallel_world_size(self) -> int:
        return self._sep_degree

    def get_sep_parallel_rank(self) -> int:
        return self._axis_rank("sep")

    def get_sep_parallel_group(self):
        return self._group("sep")

    # fused-axis groups (reference create_fuse_group / get_dp_sep_... )
    def get_data_sharding_parallel_group(self):
        """dp and sharding together: the ranks that see different data."""
        return self._group(*DATA_AXES)

    def get_dp_sep_parallel_group(self):
        return self._group("dp", "sep")

    def get_pp_mp_parallel_group(self):
        return self._group("pp", "mp")

    def get_check_parallel_group(self, sharding=False):
        return (self._group("sharding", "pp", "mp") if sharding
                else self._group("pp", "mp"))

    def get_rank_from_stage(self, stage_id: int, **kwargs) -> int:
        names = self._topo.get_hybrid_group_names()
        full = {n: (stage_id if n == "pp" else kwargs.get(n, 0))
                for n in names}
        return self._topo.get_rank(**full)


_hcg: Optional[HybridCommunicateGroup] = None


def set_hybrid_communicate_group(hcg: Optional[HybridCommunicateGroup]):
    global _hcg
    _hcg = hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _hcg
