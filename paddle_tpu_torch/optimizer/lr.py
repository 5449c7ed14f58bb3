"""Learning-rate schedulers (counterpart of ``paddle_tpu/optimizer/lr.py``).

Host-side state: an epoch (step) counter. The optimizer reads the current
rate each step; the caller advances the scheduler with ``step()``. The
semantics are the JAX package's, including two that are easy to miss:
the constructor takes the first step (epoch 0), and a ``LinearWarmup``
around another scheduler steps that scheduler from inside ``get_lr``
once warm-up is over.
"""
from __future__ import annotations

import math


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = self.base_lr
        self.step()

    def __call__(self) -> float:
        return self.last_lr

    def get_lr(self) -> float:
        raise NotImplementedError

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()
        if self.verbose:
            print(f"Epoch {self.last_epoch}: set learning rate to "
                  f"{self.last_lr}")

    def state_dict(self):
        return {k: v for k, v in self.__dict__.items()
                if isinstance(v, (int, float, bool, str, list))}

    def set_state_dict(self, state_dict):
        self.__dict__.update(state_dict)


class LinearWarmup(LRScheduler):
    """Linear from ``start_lr`` to ``end_lr`` over ``warmup_steps``, then
    ``learning_rate`` (a float, or a scheduler that it steps)."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_sched = (learning_rate if isinstance(learning_rate,
                                                     LRScheduler) else None)
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        base = (learning_rate.base_lr if self.lr_sched is not None
                else learning_rate)
        super().__init__(base, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * (
                self.last_epoch / max(self.warmup_steps, 1)) + self.start_lr
        if self.lr_sched is not None:
            self.lr_sched.step()
            return self.lr_sched.last_lr
        return self.base_lr

    def state_dict(self):
        sd = super().state_dict()
        if self.lr_sched is not None:
            sd["inner_scheduler"] = self.lr_sched.state_dict()
        return sd

    def set_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        inner = state_dict.pop("inner_scheduler", None)
        super().set_state_dict(state_dict)
        if inner is not None and self.lr_sched is not None:
            self.lr_sched.set_state_dict(inner)


class CosineAnnealingDecay(LRScheduler):
    """eta_min + (base - eta_min) * (1 + cos(pi * epoch / T_max)) / 2."""

    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return (self.eta_min + (self.base_lr - self.eta_min)
                * (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2)


__all__ = ["LRScheduler", "LinearWarmup", "CosineAnnealingDecay"]
