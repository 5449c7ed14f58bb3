"""Optimizers (counterpart of ``paddle_tpu/optimizer/optimizer.py``):
the ``Optimizer`` base, ``Adam`` and ``AdamW``.

The JAX package runs every parameter's update in one jitted program; the
port runs the same fp32 update rule with plain multi-tensor torch ops
(``torch._foreach_*``: a few launches for all parameters together, not a
few for each) on the parameters' device. It updates the moments, the
fp32 master copies and fp32 parameters in place (no second copy of the
optimizer state is made); a bf16/fp16 parameter is written back from its
fp32 result.

Parameters carry names: JAX parameter names are global counters
(``param_4``), so the port names each parameter by its dotted path in
the model when it is handed ``model.named_parameters()``, and
``param_<i>`` by position otherwise. ``apply_decay_param_fun`` and the
state-dict keys use these names.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple, Union

import torch

from .lr import LRScheduler

ParamsArg = Iterable[Union[torch.Tensor, Tuple[str, torch.Tensor]]]
_LOW_PRECISION = (torch.bfloat16, torch.float16)


class Optimizer:
    """Learning rate (a float or an ``LRScheduler``), ``grad_clip``,
    ``multi_precision`` fp32 masters for bf16/fp16 parameters,
    ``step``/``clear_grad``/``minimize`` and ``state_dict``."""

    _state_names: List[str] = []

    def __init__(self, learning_rate=0.001, parameters: ParamsArg = None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if parameters is None:
            raise ValueError("parameters is required (pass "
                             "model.named_parameters() or "
                             "model.parameters())")
        self._names: List[str] = []
        self._parameter_list: List[torch.Tensor] = []
        for i, item in enumerate(parameters):
            if isinstance(item, tuple):
                pname, p = item
            else:
                pname, p = f"param_{i}", item
            self._names.append(pname)
            self._parameter_list.append(p)
        if len(set(self._names)) != len(self._names):
            raise ValueError("parameter names must be unique")
        self._learning_rate = learning_rate
        self._weight_decay = self._coeff(weight_decay)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._accumulators: Dict[str, Dict[str, torch.Tensor]] = {}
        self._master_weights: Dict[str, torch.Tensor] = {}
        self._step_count = 0

    @staticmethod
    def _coeff(wd) -> float:
        if wd is None:
            return 0.0
        if isinstance(wd, (int, float)):
            return float(wd)
        raise NotImplementedError(
            f"later slice: weight_decay of type {type(wd).__name__} (the "
            f"port takes a float coefficient)")

    # -------------------------------------------------------------------- lr
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return float(self._learning_rate)

    def set_lr(self, value: float):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "cannot set_lr when the learning rate is a scheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler: LRScheduler):
        self._learning_rate = scheduler

    # ------------------------------------------------------------ state mgmt
    def _ensure_state(self, name: str, p: torch.Tensor):
        if name in self._accumulators:
            return
        self._accumulators[name] = {
            s: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for s in self._state_names}
        if self._multi_precision and p.dtype in _LOW_PRECISION:
            self._master_weights[name] = p.detach().float().clone()

    # ----------------------------------------------------------------- hooks
    def _update(self, ws: List[torch.Tensor], gs: List[torch.Tensor],
                states: Dict[str, List[torch.Tensor]], lr: float, step: int,
                wd_flags: List[float]) -> None:
        """Update the fp32 tensors ``ws`` and the lists in ``states`` (one
        per state name) in place from the fp32 gradients ``gs``; the i-th
        entry of each list belongs to one parameter. Subclasses
        implement."""
        raise NotImplementedError

    def _wd_flag(self, name: str) -> float:
        return 1.0

    # ------------------------------------------------------------------ step
    @torch.no_grad()
    def step(self):
        live = [(n, p) for n, p in zip(self._names, self._parameter_list)
                if p.requires_grad and p.grad is not None]
        if not live:
            return
        params_grads = [(p, p.grad) for _, p in live]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._step_count += 1
        works, grads, back = [], [], []
        for (name, p), (_, g) in zip(live, params_grads):
            self._ensure_state(name, p)
            work = self._master_weights.get(name)
            if work is None:
                work = p if p.dtype == torch.float32 else p.float()
            if work is not p:
                back.append((p, work))
            works.append(work)
            grads.append(g.float())
        states = {s: [self._accumulators[n][s] for n, _ in live]
                  for s in self._state_names}
        self._update(works, grads, states, float(self.get_lr()),
                     self._step_count, [self._wd_flag(n) for n, _ in live])
        for p, work in back:
            p.copy_(work)

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    # ------------------------------------------------------------- save/load
    def state_dict(self) -> dict:
        """``{name}_{moment}`` and ``{name}_master`` copies, the step count
        and the scheduler's state, under the JAX package's keys."""
        sd = {}
        for name in self._names:
            st = self._accumulators.get(name)
            if st is None:
                continue
            for s, v in st.items():
                sd[f"{name}_{s}"] = v.detach().clone()
            mw = self._master_weights.get(name)
            if mw is not None:
                sd[f"{name}_master"] = mw.detach().clone()
        sd["@step_count"] = self._step_count
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    def set_state_dict(self, state_dict: dict):
        self._step_count = int(state_dict.get("@step_count", 0))
        if "LR_Scheduler" in state_dict and isinstance(self._learning_rate,
                                                       LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        for name, p in zip(self._names, self._parameter_list):
            st = {s: torch.as_tensor(state_dict[f"{name}_{s}"]).to(
                      device=p.device, dtype=torch.float32).clone()
                  for s in self._state_names
                  if f"{name}_{s}" in state_dict}
            if st:
                self._accumulators[name] = st
            if f"{name}_master" in state_dict:
                self._master_weights[name] = torch.as_tensor(
                    state_dict[f"{name}_master"]).to(
                        device=p.device, dtype=torch.float32).clone()


class Adam(Optimizer):
    """Adam with fp32 moments; ``weight_decay`` is L2 folded into the
    gradient. bf16/int8 moments (``moment_dtype``) and ``amsgrad`` are a
    later slice."""

    _state_names = ["moment1", "moment2"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, moment_dtype=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        if moment_dtype is not None or amsgrad:
            raise NotImplementedError(
                "later slice: moment_dtype (bf16/int8 moments) and amsgrad")
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _moments(self, gs, states, step):
        """m and v updated in place; returns the bias corrections."""
        b1, b2 = self._beta1, self._beta2
        ms, vs = states["moment1"], states["moment2"]
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, gs, alpha=1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, gs, gs, value=1 - b2)
        return 1 - b1 ** step, 1 - b2 ** step

    def _apply(self, ws, states, lr, bc1, bc2):
        """w -= lr * m_hat / (sqrt(v_hat) + eps)."""
        denom = torch._foreach_div(states["moment2"], bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._epsilon)
        torch._foreach_addcdiv_(ws, states["moment1"], denom, value=-lr / bc1)

    def _update(self, ws, gs, states, lr, step, wd_flags):
        if self._weight_decay:     # L2: g + coeff * w, per the flag
            gs = torch._foreach_add(
                gs, torch._foreach_mul(ws, [self._weight_decay * f
                                            for f in wd_flags]))
        bc1, bc2 = self._moments(gs, states, step)
        self._apply(ws, states, lr, bc1, bc2)


class AdamW(Adam):
    """Decoupled weight decay: w *= 1 - lr * weight_decay before the Adam
    step, for the parameters ``apply_decay_param_fun(name)`` accepts (all
    when it is None)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 moment_dtype=None, name=None):
        if lr_ratio is not None:
            raise NotImplementedError("later slice: lr_ratio")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, moment_dtype=moment_dtype,
                         name=name)
        self._wd_coeff = self._coeff(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _wd_flag(self, name):
        if self._apply_decay_param_fun is not None:
            return 1.0 if self._apply_decay_param_fun(name) else 0.0
        return 1.0

    def _update(self, ws, gs, states, lr, step, wd_flags):
        bc1, bc2 = self._moments(gs, states, step)
        if self._wd_coeff:
            torch._foreach_mul_(ws, [1 - lr * self._wd_coeff * f
                                     for f in wd_flags])
        self._apply(ws, states, lr, bc1, bc2)


__all__ = ["Optimizer", "Adam", "AdamW"]
