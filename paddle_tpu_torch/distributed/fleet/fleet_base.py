"""The Fleet facade, collective mode (counterpart of
``paddle_tpu/distributed/fleet/fleet_base.py``; reference
python/paddle/distributed/fleet/fleet.py:100).

``init`` joins the world (``init_parallel_env``), checks the strategy's
``hybrid_configs`` degrees against the world size as the JAX package's
``_init_hybrid_parallel_env`` does (dp -1 fills the rest), and builds the
hybrid topology: the process mesh of the axes in ``order`` and its
groups. ``distributed_model`` picks the wrapper as the JAX package does
(pipeline and sep: later slices, and raise); ``distributed_optimizer``
wraps in ``HybridParallelOptimizer``; ``collective_perf`` times a
collective. Parameter-server mode is a later slice: its methods raise.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch.distributed as dist

from ..parallel import init_parallel_env
from .base.distributed_strategy import DistributedStrategy
from .base.topology import (AXIS_ORDER, CommunicateTopology,
                            HybridCommunicateGroup,
                            set_hybrid_communicate_group)
from .meta_optimizers.hybrid_parallel_optimizer import \
    HybridParallelOptimizer

_DEGREE_KEYS = {"dp": "dp_degree", "pp": "pp_degree",
                "sharding": "sharding_degree", "sep": "sep_degree",
                "mp": "mp_degree"}
PS_SLICE = ("parameter-server mode is a later slice of the port "
            "(distributed/ps, rpc)")


class Fleet:
    def __init__(self):
        self._is_initialized = False
        self._hcg: Optional[HybridCommunicateGroup] = None
        self._strategy: Optional[DistributedStrategy] = None

    # ------------------------------------------------------------------ init
    def init(self, role_maker=None, is_collective=True, strategy=None,
             log_level="INFO"):
        if not is_collective or (role_maker is not None and not getattr(
                role_maker, "_is_collective", True)):
            raise NotImplementedError(PS_SLICE)
        self._strategy = strategy if strategy is not None else \
            DistributedStrategy()
        init_parallel_env()
        self._init_hybrid_parallel_env(self._strategy)
        self._is_initialized = True
        return self

    def _init_hybrid_parallel_env(self, strategy):
        """reference fleet.py:599: the degrees against the world size,
        then the topology and its groups."""
        cfg = strategy.hybrid_configs
        n = dist.get_world_size()
        degrees = {}
        fixed = 1
        for axis in AXIS_ORDER:
            d = int(cfg.get(_DEGREE_KEYS[axis], 1))
            degrees[axis] = d
            if axis != "dp" and d > 1:
                fixed *= d
        dp = degrees["dp"]
        if dp in (-1, 0):
            if n % fixed:
                raise ValueError(
                    f"world size {n} not divisible by non-dp degrees "
                    f"{fixed}")
            dp = n // fixed
        degrees["dp"] = max(dp, 1)
        total = int(np.prod(list(degrees.values())))
        if total != n:
            raise ValueError(
                f"hybrid degrees {degrees} need {total} ranks, the world "
                f"has {n}")
        order = list(cfg.get("order") or AXIS_ORDER)
        if sorted(order) != sorted(AXIS_ORDER):
            raise ValueError(
                f"hybrid_configs['order'] must be a permutation of "
                f"{list(AXIS_ORDER)}, got {order}")
        self._hcg = HybridCommunicateGroup(
            CommunicateTopology(order, [degrees[a] for a in order]))
        set_hybrid_communicate_group(self._hcg)

    # ----------------------------------------------------------------- state
    @property
    def is_initialized(self):
        return self._is_initialized

    def get_hybrid_communicate_group(self) -> HybridCommunicateGroup:
        return self._hcg

    def worker_num(self) -> int:
        return dist.get_world_size() if dist.is_initialized() else 1

    def worker_index(self) -> int:
        return dist.get_rank() if dist.is_initialized() else 0

    def is_first_worker(self) -> bool:
        return self.worker_index() == 0

    def is_worker(self) -> bool:
        return True

    def barrier_worker(self, key: str = "worker"):
        from ..communication.collective import barrier
        barrier()

    # --------------------------------------------------- parameter servers
    def is_server(self) -> bool:
        return False

    def server_index(self) -> int:
        raise NotImplementedError(PS_SLICE)

    def server_num(self) -> int:
        raise NotImplementedError(PS_SLICE)

    def init_server(self, dirname=None):
        raise NotImplementedError(PS_SLICE)

    def run_server(self):
        raise NotImplementedError(PS_SLICE)

    def init_worker(self):
        raise NotImplementedError(PS_SLICE)

    def stop_worker(self):
        """No-op outside PS mode (reference training scripts call it
        unconditionally)."""

    # ------------------------------------------------------------- wrapping
    def distributed_model(self, model):
        """reference model.py:32/:132-151 wrapper selection."""
        from ..parallel import DataParallel
        from .meta_parallel import ShardingParallel, TensorParallel
        hcg = self._hcg
        if hcg is None:
            raise RuntimeError("distributed_model: call fleet.init() first")
        if hcg.get_pipe_parallel_world_size() > 1:
            raise NotImplementedError(
                "pipeline parallel (pp_degree > 1) is a later slice of the "
                "port")
        if hcg.get_model_parallel_world_size() > 1:
            return TensorParallel(model, hcg, self._strategy)
        if hcg.get_sharding_parallel_world_size() > 1:
            return ShardingParallel(model, hcg, self._strategy)
        if hcg.get_sep_parallel_world_size() > 1:
            raise NotImplementedError(
                "the sep axis (sep_degree > 1) is a later slice of the port")
        s = self._strategy or DistributedStrategy()
        return DataParallel(
            model, comm_buffer_size=s.fuse_grad_size_in_MB,
            last_comm_buffer_size=s.last_comm_group_size_MB,
            find_unused_parameters=s.find_unused_parameters,
            group=hcg.get_data_parallel_group())

    def collective_perf(self, comm_type: str = "allreduce",
                        round_num: int = 10, size_and_time=None):
        """The collective self-test (reference fleet.py:363-564): run
        ``comm_type`` over the world ``round_num`` times at each size in
        bytes of ``size_and_time`` (bytes -> seconds threshold or None),
        synchronised; warn over a threshold. Returns {bytes: seconds a
        call}."""
        import time
        import torch
        from ..communication import collective as C

        def reduce_scatter(t):
            return C.reduce_scatter(None, t)
        ops = {"allreduce": C.all_reduce,
               "allgather": lambda t: C.all_gather([], t),
               "broadcast": lambda t: C.broadcast(t, src=0),
               "reduce": lambda t: C.reduce(t, dst=0),
               "reduce_scatter": reduce_scatter}
        fn = ops.get(comm_type)
        if fn is None:
            raise ValueError(f"unknown comm_type {comm_type}")
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        sync = (torch.cuda.synchronize if dev.type == "cuda"
                else (lambda: None))
        results = {}
        world = dist.get_world_size()
        for nbytes, threshold in (size_and_time or {1 << 20: None}).items():
            n = max(int(nbytes) // 4 // world, 1) * world
            t = torch.ones(n, device=dev)
            fn(t)
            sync()
            start = time.perf_counter()
            for _ in range(round_num):
                fn(t)
            sync()
            results[nbytes] = (time.perf_counter() - start) / round_num
            if threshold is not None and results[nbytes] > threshold:
                print(f"[perf warning] {comm_type} at {nbytes}B took "
                      f"{results[nbytes]:.6f}s/iter > threshold "
                      f"{threshold}s")
        return results

    def distributed_optimizer(self, optimizer, strategy=None):
        if self._hcg is None:
            raise RuntimeError("distributed_optimizer: call fleet.init() "
                               "first")
        return HybridParallelOptimizer(optimizer, self._hcg,
                                       strategy or self._strategy)


fleet = Fleet()
