"""The hybrid-parallel optimizer (counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers/hybrid_parallel_optimizer.py``;
reference dygraph_optimizer/hybrid_parallel_optimizer.py:255).

The JAX package's gradients are global arrays, so a norm over them is
already global. The port's ranks hold shards and copies, as the
reference's do:

* ``HybridParallelOptimizer.step`` averages the gradients over the
  data-parallel ranks (dp, and sharding) when the model is not a
  ``DataParallel`` (whose reducer did it in backward), then steps the
  inner optimizer — wrapped in ``DygraphShardingOptimizer`` (ZeRO-1)
  when the sharding degree is above 1, as the JAX facade wraps it;
* ``HybridParallelClipGrad`` takes the global norm across ranks: the
  squares of the gradients of parameters split over mp
  (``is_distributed``) are summed over the mp group, those of replicated
  parameters counted once, and under ZeRO-1 (each rank clips only the
  parameters it owns) the total is summed over the sharding group.
"""
from __future__ import annotations

import torch

from ....nn.clip import ClipGradByGlobalNorm, _clipped
from ...communication import collective as C
from ..base.topology import ParallelMode
from ..mpu.mp_layers import is_split
from ..utils.hybrid_parallel_util import fused_allreduce_gradients
from .dygraph_sharding_optimizer import DygraphShardingOptimizer


class HybridParallelClipGrad:
    """Global-norm clip across the parallel axes (reference :41)."""

    def __init__(self, clip, hcg):
        self._clip = clip
        self._hcg = hcg

    @property
    def clip_norm(self):
        return self._clip.clip_norm

    def __call__(self, params_grads):
        return self._dygraph_clip(params_grads)

    @torch.no_grad()
    def _dygraph_clip(self, params_grads):
        grads = [(p, g) for p, g in params_grads
                 if g is not None and _clipped(p)]
        if not grads:
            return params_grads
        dev = grads[0][1].device
        dist_sq = torch.zeros((), device=dev)
        rep_sq = torch.zeros((), device=dev)
        for p, g in grads:
            s = g.float().pow(2).sum()
            if is_split(p):
                dist_sq += s
            else:
                rep_sq += s
        hcg = self._hcg
        if hcg.get_model_parallel_world_size() > 1:
            C.all_reduce(dist_sq, group=hcg.get_model_parallel_group())
        total = dist_sq + rep_sq
        if hcg.get_sharding_parallel_world_size() > 1:
            C.all_reduce(total, group=hcg.get_sharding_parallel_group())
        norm = torch.sqrt(total)
        clip = self._clip.clip_norm
        scale = clip / torch.clamp(norm, min=clip)
        return [(p, (g.float() * scale).to(g.dtype)
                 if g is not None and _clipped(p) else g)
                for p, g in params_grads]


class HybridParallelOptimizer:
    """reference hybrid_parallel_optimizer.py:255."""

    def __init__(self, optimizer, hcg, strategy=None):
        self._hcg = hcg
        self._strategy = strategy
        if strategy is not None and getattr(strategy, "gradient_merge",
                                            False):
            raise NotImplementedError(
                "gradient_merge: a later slice of the port (accumulate "
                "with DataParallel.no_sync() meanwhile)")
        # DataParallel's reducer already averaged the gradients in dp mode
        self._dp_sync = (hcg.get_parallel_mode() !=
                         ParallelMode.DATA_PARALLEL and
                         (hcg.get_data_parallel_world_size() > 1 or
                          hcg.get_sharding_parallel_world_size() > 1))
        self._all_params = list(optimizer._parameter_list)
        inner = optimizer
        if isinstance(inner._grad_clip, ClipGradByGlobalNorm):
            inner._grad_clip = HybridParallelClipGrad(inner._grad_clip, hcg)
        if hcg.get_sharding_parallel_world_size() > 1 and not isinstance(
                optimizer, DygraphShardingOptimizer):
            optimizer = DygraphShardingOptimizer(optimizer, hcg)
        self._inner_opt = optimizer

    def step(self):
        if self._dp_sync:
            fused_allreduce_gradients(self._all_params, self._hcg)
        self._inner_opt.step()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._all_params:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)
