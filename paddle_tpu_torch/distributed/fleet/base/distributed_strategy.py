"""DistributedStrategy — the Fleet configuration object (counterpart of
``paddle_tpu/distributed/fleet/base/distributed_strategy.py``; reference
python/paddle/distributed/fleet/base/distributed_strategy.py).

A plain attribute bag with the JAX package's fields and defaults: the
``hybrid_configs`` degrees define the process mesh's axis sizes
(dp/pp/sharding/sep/mp) and ``order`` their order; ``fuse_grad_size_in_MB``
and ``last_comm_group_size_MB`` size ``DataParallel``'s buckets.
"""
from __future__ import annotations

from typing import Any, Dict

_HYBRID_DEFAULTS = {
    "dp_degree": -1,          # -1: fill with the remaining ranks
    "mp_degree": 1,
    "pp_degree": 1,
    "sharding_degree": 1,
    "sep_degree": 1,
    "order": ["dp", "pp", "sharding", "sep", "mp"],
}

_PP_DEFAULTS = {
    "micro_batch_size": 1,
    "accumulate_steps": 1,
    "schedule_mode": "1F1B",   # FThenB | 1F1B
    "p2p_cache_shape": True,
}


class DistributedStrategy:
    @staticmethod
    def _hybrid_defaults() -> Dict[str, Any]:
        cfg = dict(_HYBRID_DEFAULTS)
        cfg["order"] = list(_HYBRID_DEFAULTS["order"])
        return cfg

    def __init__(self):
        self._hybrid_configs: Dict[str, Any] = self._hybrid_defaults()
        self.pipeline_configs: Dict[str, Any] = dict(_PP_DEFAULTS)
        self.amp = False
        self.amp_configs: Dict[str, Any] = {"init_loss_scaling": 32768.0,
                                            "use_pure_fp16": False,
                                            "custom_white_list": [],
                                            "custom_black_list": []}
        self.recompute = False
        self.recompute_configs: Dict[str, Any] = {"checkpoints": []}
        self.gradient_merge = False
        self.gradient_merge_configs: Dict[str, Any] = {"k_steps": 1,
                                                       "avg": True}
        self.sharding = False
        self.sharding_configs: Dict[str, Any] = {"stage": 1,
                                                 "degree": 1}
        self.find_unused_parameters = False
        self.fuse_grad_size_in_MB = 32
        self.last_comm_group_size_MB = 1
        self.tensor_parallel_configs: Dict[str, Any] = {
            "tensor_init_seed": -1}
        self.hybrid_parallel_order = list(_HYBRID_DEFAULTS["order"])

    @property
    def hybrid_configs(self) -> Dict[str, Any]:
        return self._hybrid_configs

    @hybrid_configs.setter
    def hybrid_configs(self, configs: Dict[str, Any]):
        merged = self._hybrid_defaults()
        merged.update(configs or {})
        self._hybrid_configs = merged

    def __repr__(self):
        return (f"DistributedStrategy(hybrid_configs={self._hybrid_configs},"
                f" pipeline_configs={self.pipeline_configs})")
