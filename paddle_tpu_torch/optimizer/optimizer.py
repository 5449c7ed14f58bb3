"""Optimizers (counterpart of ``paddle_tpu/optimizer/optimizer.py``):
the ``Optimizer`` base, ``SGD``, ``Momentum``, ``Adam``, ``AdamW``,
``Adagrad``, ``RMSProp``, ``Adadelta``, ``Adamax``, ``Lamb``, ``NAdam``
and ``RAdam``, each with the JAX package's update rule and state names.

The JAX package runs every parameter's update in one jitted program; the
port runs the same fp32 update rule with plain multi-tensor torch ops
(``torch._foreach_*``: a few launches for all parameters together, not a
few for each) on the parameters' device. It updates the moments, the
fp32 master copies and fp32 parameters in place (no second copy of the
optimizer state is made); a bf16/fp16 parameter is written back from its
fp32 result. Parameters are updated in groups of at most ``_GROUP_NUMEL``
values, so the fp32 copies of the gradients and the update's temporaries
exist for one group at a time, never for the whole model.

Adam's moments may be stored as bf16, or as int8 in blocks of 256 values
with one fp32 absmax scale a block (``moment_dtype``; v is quantized in
sqrt space). Those are decoded to fp32, updated and encoded one
parameter at a time, so no fp32 copy of all the moments exists at once;
checkpoints hold them decoded, in fp32.

Parameters carry names: JAX parameter names are global counters
(``param_4``), so the port names each parameter by its dotted path in
the model when it is handed ``model.named_parameters()``, and
``param_<i>`` by position otherwise. ``apply_decay_param_fun`` and the
state-dict keys use these names. ``set_state_dict`` skips keys it does
not find, as the JAX package's does, so a state saved under other names
restores no moments (only ``@step_count`` and the scheduler).

The parameters may be ``torch.Tensor``s (the torch-level models) or
Paddle-API ``Parameter``s (``layer.parameters()``, as the JAX package's
optimizers take them); a Parameter is updated through its leaf payload,
under its own name, with its ``need_clip``.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple, Union

import torch

from ..core.tensor import Tensor, _payload, graph_break
from .lr import LRScheduler

ParamsArg = Iterable[Union[torch.Tensor, Tuple[str, torch.Tensor]]]
_LOW_PRECISION = (torch.bfloat16, torch.float16)

#: values a block in int8 moment storage, each block with one fp32 scale
_MOMENT_BLOCK = 256
#: values a group of parameters updated together holds at most (one
#: parameter larger than this is a group of its own)
_GROUP_NUMEL = 1 << 26


def _groups(items, numel):
    """Consecutive runs of ``items`` whose ``numel(item)`` sum to at most
    ``_GROUP_NUMEL``."""
    group, size = [], 0
    for item in items:
        n = numel(item)
        if group and size + n > _GROUP_NUMEL:
            yield group
            group, size = [], 0
        group.append(item)
        size += n
    if group:
        yield group


def _moment_encode(x: torch.Tensor, dtype: Optional[str],
                   nonneg: bool = False):
    """fp32 moment -> storage form: itself (``dtype`` None), bf16, or for
    int8 ``{"q": int8 (blocks, 256), "s": fp32 (blocks, 1)}``: flattened,
    padded with zeros to whole blocks, each block scaled by its absmax /
    127 and rounded half to even. A non-negative moment (Adam's v) is
    quantized in sqrt space, which keeps the small entries that set the
    effective step."""
    if dtype is None:
        return x
    if dtype == "bfloat16":
        return x.to(torch.bfloat16)
    if nonneg:
        x = torch.sqrt(torch.clamp_min(x, 0.0))
    flat = x.reshape(-1)
    pad = (-flat.numel()) % _MOMENT_BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, _MOMENT_BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp_min(scale, 1e-30)).clamp(
        -127, 127).to(torch.int8)
    return {"q": q, "s": scale.float()}


def _moment_decode(st, shape, dtype: Optional[str],
                   nonneg: bool = False) -> torch.Tensor:
    """Storage form -> fp32 moment of ``shape``."""
    if dtype is None:
        return st
    if dtype == "bfloat16":
        return st.float()
    size = 1
    for d in shape:
        size *= int(d)
    out = (st["q"].float() * st["s"]).reshape(-1)[:size].reshape(shape)
    return out * out if nonneg else out


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
        #: name -> the object given for it (a Parameter or a torch.Tensor)
        self._given: Dict[str, object] = {}
        for i, item in enumerate(parameters):
            if isinstance(item, tuple):
                pname, p = item
            else:
                pname = item.name if isinstance(item, Tensor) else \
                    f"param_{i}"
                p = item
            self._given[pname] = p
            if isinstance(p, Tensor):
                p._data.need_clip = getattr(p, "need_clip", True)
                p = p._data
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
        self._accumulators[name] = self._init_state(p)
        if self._multi_precision and p.dtype in _LOW_PRECISION:
            self._master_weights[name] = p.detach().float().clone()

    def _init_state(self, p: torch.Tensor) -> dict:
        return {s: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for s in self._state_names}

    def _state_to_checkpoint(self, state: str, v, p: torch.Tensor
                             ) -> torch.Tensor:
        """Storage form -> the fp32 tensor a checkpoint holds."""
        return v.detach().clone()

    def _state_from_checkpoint(self, state: str, arr: torch.Tensor,
                               p: torch.Tensor):
        return arr

    # ----------------------------------------------------------------- hooks
    def _update(self, ws: List[torch.Tensor], gs: List[torch.Tensor],
                states: Dict[str, list], lr: float, step: int,
                wd_flags: List[float]) -> None:
        """Update the fp32 tensors ``ws`` in place from the fp32 gradients
        ``gs``, and the lists in ``states`` (one per state name; the i-th
        entry of each list belongs to one parameter), in place or by
        putting new entries in the lists. Subclasses implement."""
        raise NotImplementedError

    def _wd_flag(self, name: str) -> float:
        return 1.0

    def _apply_decay(self, ws, gs, wd_flags):
        """L2 regularization folded into the gradients: g + coeff * w for
        each parameter, scaled by its flag (new lists; ``gs`` when there
        is no decay)."""
        if not self._weight_decay:
            return gs
        return torch._foreach_add(
            gs, torch._foreach_mul(ws, [self._weight_decay * f
                                        for f in wd_flags]))

    # ------------------------------------------------------------------ step
    @torch.no_grad()
    def step(self):
        graph_break("Optimizer.step()")
        live = [(n, p) for n, p in zip(self._names, self._parameter_list)
                if p.requires_grad and p.grad is not None]
        if not live:
            return
        params_grads = [(p, p.grad) for _, p in live]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._step_count += 1
        lr = float(self.get_lr())
        for group in _groups(zip(live, params_grads),
                             lambda item: item[0][1].numel()):
            names = [name for (name, _), _ in group]
            works, grads, back = [], [], []
            for (name, p), (_, g) in group:
                self._ensure_state(name, p)
                work = self._master_weights.get(name)
                if work is None:
                    work = p if p.dtype == torch.float32 else p.float()
                if work is not p:
                    back.append((p, work))
                works.append(work)
                grads.append(g.float())
            states = {s: [self._accumulators[n][s] for n in names]
                      for s in self._state_names}
            self._update(works, grads, states, lr, self._step_count,
                         [self._wd_flag(n) for n in names])
            for s, values in states.items():
                for name, v in zip(names, values):
                    self._accumulators[name][s] = v
            for p, work in back:
                p.copy_(work)

    def clear_grad(self, set_to_zero: bool = False):
        graph_break("Optimizer.clear_grad()")
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
        for name, p in zip(self._names, self._parameter_list):
            st = self._accumulators.get(name)
            if st is None:
                continue
            for s, v in st.items():
                sd[f"{name}_{s}"] = self._state_to_checkpoint(s, v, p)
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

        def fp32(v, p):             # a copy: the state dict is not kept
            return torch.as_tensor(_payload(v)).to(
                device=p.device, dtype=torch.float32).clone()
        for name, p in zip(self._names, self._parameter_list):
            st = {s: self._state_from_checkpoint(
                      s, fp32(state_dict[f"{name}_{s}"], p), p)
                  for s in self._state_names
                  if f"{name}_{s}" in state_dict}
            if st:
                self._accumulators[name] = st
            if f"{name}_master" in state_dict:
                self._master_weights[name] = fp32(
                    state_dict[f"{name}_master"], p)


class SGD(Optimizer):
    """w -= lr * (g + weight_decay * w): plain SGD with L2 folded into the
    gradient, as the JAX package's; no state."""

    def _update(self, ws, gs, states, lr, step, wd_flags):
        torch._foreach_add_(ws, self._apply_decay(ws, gs, wd_flags),
                            alpha=-lr)


class Momentum(Optimizer):
    """v = momentum * v + g, w -= lr * v (Nesterov: w -= lr * (g +
    momentum * v)); ``weight_decay`` is L2 folded into g."""

    _state_names = ["velocity"]

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _update(self, ws, gs, states, lr, step, wd_flags):
        gs = self._apply_decay(ws, gs, wd_flags)
        vs = states["velocity"]
        torch._foreach_mul_(vs, self._momentum)
        torch._foreach_add_(vs, gs)
        if self._nesterov:
            torch._foreach_add_(ws, torch._foreach_add(
                gs, vs, alpha=self._momentum), alpha=-lr)
        else:
            torch._foreach_add_(ws, vs, alpha=-lr)


class Adam(Optimizer):
    """Adam; ``weight_decay`` is L2 folded into the gradient.
    ``moment_dtype``: None (fp32 moments), ``"bfloat16"`` or ``"int8"``
    (blockwise). ``amsgrad`` steps with the running max of v
    (``moment2_max``); it refuses int8 moments, whose requantization would
    drift a running max. The update math runs in fp32 either way."""

    _state_names = ["moment1", "moment2"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, moment_dtype=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        if moment_dtype not in (None, "bfloat16", "int8"):
            raise ValueError(
                f"moment_dtype must be None, 'bfloat16' or 'int8', got "
                f"{moment_dtype!r}")
        if amsgrad and moment_dtype == "int8":
            raise ValueError("amsgrad tracks a running max; int8 "
                             "requantization would drift it — use "
                             "moment_dtype='bfloat16' or None")
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._amsgrad = amsgrad
        self._moment_dtype = moment_dtype
        if amsgrad:
            self._state_names = self._state_names + ["moment2_max"]

    def _init_state(self, p):
        if self._moment_dtype is None:
            return super()._init_state(p)
        zero = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {s: _moment_encode(zero, self._moment_dtype,
                                  nonneg=s.startswith("moment2"))
                for s in self._state_names}

    def _state_to_checkpoint(self, state, v, p):
        return _moment_decode(v, p.shape, self._moment_dtype,
                              nonneg=state.startswith("moment2")
                              ).detach().clone()

    def _state_from_checkpoint(self, state, arr, p):
        return _moment_encode(arr, self._moment_dtype,
                              nonneg=state.startswith("moment2"))

    def _update(self, ws, gs, states, lr, step, wd_flags):
        md = self._moment_dtype
        if md is None:
            self._update_fp32(ws, gs, states, lr, step, wd_flags)
            return
        for i, w in enumerate(ws):    # one parameter's moments at a time
            one = {s: [_moment_decode(v[i], w.shape, md,
                                      nonneg=s.startswith("moment2"))]
                   for s, v in states.items()}
            self._update_fp32([w], [gs[i]], one, lr, step, [wd_flags[i]])
            for s, v in states.items():
                v[i] = _moment_encode(one[s][0], md,
                                      nonneg=s.startswith("moment2"))

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
        """w -= lr * m_hat / (sqrt(v_hat) + eps); with amsgrad v_hat is
        the running max of v, bias-corrected."""
        v = states["moment2"]
        if self._amsgrad:
            torch._foreach_maximum_(states["moment2_max"], v)
            v = states["moment2_max"]
        torch._foreach_addcdiv_(ws, states["moment1"],
                                self._sqrt_v_hat(v, bc2), value=-lr / bc1)

    def _update_fp32(self, ws, gs, states, lr, step, wd_flags):
        """The update on fp32 moments, in place."""
        gs = self._apply_decay(ws, gs, wd_flags)
        bc1, bc2 = self._moments(gs, states, step)
        self._apply(ws, states, lr, bc1, bc2)

    def _sqrt_v_hat(self, vs, bc2):
        """sqrt(v / bc2) + eps for each v of ``vs``, a new list."""
        denom = torch._foreach_div(vs, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._epsilon)
        return denom


class AdamW(Adam):
    """Decoupled weight decay: w *= 1 - lr * weight_decay before the Adam
    step, for the parameters ``apply_decay_param_fun(name)`` accepts (all
    when it is None). ``amsgrad`` works as in ``Adam`` (the JAX package's
    AdamW ignores it, a fault of the reference)."""

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

    def _update_fp32(self, ws, gs, states, lr, step, wd_flags):
        bc1, bc2 = self._moments(gs, states, step)
        if self._wd_coeff:
            torch._foreach_mul_(ws, [1 - lr * self._wd_coeff * f
                                     for f in wd_flags])
        self._apply(ws, states, lr, bc1, bc2)


class Adagrad(Optimizer):
    """G += g * g, w -= lr * g / (sqrt(G) + eps); G starts at
    ``initial_accumulator_value``."""

    _state_names = ["moment"]

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._epsilon = epsilon
        self._init_value = initial_accumulator_value

    def _init_state(self, p):
        return {"moment": torch.full(p.shape, float(self._init_value),
                                     dtype=torch.float32, device=p.device)}

    def _update(self, ws, gs, states, lr, step, wd_flags):
        gs = self._apply_decay(ws, gs, wd_flags)
        moms = states["moment"]
        torch._foreach_addcmul_(moms, gs, gs)
        denom = torch._foreach_sqrt(moms)
        torch._foreach_add_(denom, self._epsilon)
        torch._foreach_addcdiv_(ws, gs, denom, value=-lr)


class RMSProp(Optimizer):
    """E[g^2] = rho E[g^2] + (1 - rho) g^2 (centered: minus E[g]^2 under
    the root); mom = momentum * mom + lr * g / sqrt(... + eps);
    w -= mom."""

    _state_names = ["mean_square", "mean_grad", "momentum"]

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _update(self, ws, gs, states, lr, step, wd_flags):
        gs = self._apply_decay(ws, gs, wd_flags)
        rho = self._rho
        ms, mg, mom = (states["mean_square"], states["mean_grad"],
                       states["momentum"])
        torch._foreach_mul_(ms, rho)
        torch._foreach_addcmul_(ms, gs, gs, value=1 - rho)
        if self._centered:
            torch._foreach_mul_(mg, rho)
            torch._foreach_add_(mg, gs, alpha=1 - rho)
            denom = torch._foreach_addcmul(ms, mg, mg, value=-1.0)
            torch._foreach_add_(denom, self._epsilon)
        else:
            denom = torch._foreach_add(ms, self._epsilon)
        torch._foreach_sqrt_(denom)
        torch._foreach_mul_(mom, self._momentum)
        torch._foreach_addcdiv_(mom, gs, denom, value=lr)
        torch._foreach_sub_(ws, mom)


class Adadelta(Optimizer):
    """E[g^2] = rho E[g^2] + (1 - rho) g^2; u = sqrt(E[u^2] + eps) /
    sqrt(E[g^2] + eps) * g; E[u^2] = rho E[u^2] + (1 - rho) u^2;
    w -= lr * u."""

    _state_names = ["avg_squared_grad", "avg_squared_update"]

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._epsilon = epsilon
        self._rho = rho

    def _update(self, ws, gs, states, lr, step, wd_flags):
        gs = self._apply_decay(ws, gs, wd_flags)
        rho, eps = self._rho, self._epsilon
        asg, asu = states["avg_squared_grad"], states["avg_squared_update"]
        torch._foreach_mul_(asg, rho)
        torch._foreach_addcmul_(asg, gs, gs, value=1 - rho)
        upd = torch._foreach_add(asu, eps)
        torch._foreach_sqrt_(upd)
        den = torch._foreach_add(asg, eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, gs)
        torch._foreach_mul_(asu, rho)
        torch._foreach_addcmul_(asu, upd, upd, value=1 - rho)
        torch._foreach_add_(ws, upd, alpha=-lr)


class Adamax(Optimizer):
    """m = b1 m + (1 - b1) g, u = max(b2 u, |g|),
    w -= lr / (1 - b1^t) * m / (u + eps)."""

    _state_names = ["moment", "inf_norm"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _update(self, ws, gs, states, lr, step, wd_flags):
        gs = self._apply_decay(ws, gs, wd_flags)
        b1 = self._beta1
        ms, us = states["moment"], states["inf_norm"]
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, gs, alpha=1 - b1)
        torch._foreach_mul_(us, self._beta2)
        torch._foreach_maximum_(us, torch._foreach_abs(gs))
        denom = torch._foreach_add(us, self._epsilon)
        torch._foreach_addcdiv_(ws, ms, denom, value=-lr / (1 - b1 ** step))


class Lamb(Optimizer):
    """Adam's direction plus ``lamb_weight_decay`` * w, scaled by the
    trust ratio ||w|| / ||r|| of each parameter (1 where either norm is
    0); ``exclude_from_weight_decay_fn(param)`` turns the decay off for a
    parameter (it is given the object the optimizer was given)."""

    _state_names = ["moment1", "moment2"]

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._lamb_wd = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _wd_flag(self, name):
        if self._exclude_fn is not None and \
                self._exclude_fn(self._given[name]):
            return 0.0
        return 1.0

    def _update(self, ws, gs, states, lr, step, wd_flags):
        b1, b2 = self._beta1, self._beta2
        ms, vs = states["moment1"], states["moment2"]
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, gs, alpha=1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, gs, gs, value=1 - b2)
        denom = torch._foreach_div(vs, 1 - b2 ** step)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._epsilon)
        rs = torch._foreach_div(ms, 1 - b1 ** step)
        torch._foreach_div_(rs, denom)
        torch._foreach_add_(rs, torch._foreach_mul(
            ws, [self._lamb_wd * f for f in wd_flags]))
        trust = [torch.where((wn > 0) & (rn > 0), wn / rn, 1.0)
                 for wn, rn in zip(torch._foreach_norm(ws),
                                   torch._foreach_norm(rs))]
        torch._foreach_mul_(rs, trust)
        torch._foreach_add_(ws, rs, alpha=-lr)


class NAdam(Adam):
    """Adam with Nesterov momentum: m_hat = (b1 m + (1 - b1) g) /
    (1 - b1^(t+1))."""

    def _update_fp32(self, ws, gs, states, lr, step, wd_flags):
        gs = self._apply_decay(ws, gs, wd_flags)
        b1 = self._beta1
        _, bc2 = self._moments(gs, states, step)
        m_hat = torch._foreach_mul(states["moment1"], b1)
        torch._foreach_add_(m_hat, gs, alpha=1 - b1)
        torch._foreach_addcdiv_(ws, m_hat,
                                self._sqrt_v_hat(states["moment2"], bc2),
                                value=-lr / (1 - b1 ** (step + 1)))


class RAdam(Adam):
    """Rectified Adam: the adaptive step, scaled by the variance
    rectification r, once rho_t > 5; the momentum step before."""

    def _update_fp32(self, ws, gs, states, lr, step, wd_flags):
        gs = self._apply_decay(ws, gs, wd_flags)
        b2 = self._beta2
        bc1, bc2 = self._moments(gs, states, step)
        rho_inf = 2.0 / (1 - b2) - 1
        rho_t = rho_inf - 2 * step * b2 ** step / (1 - b2 ** step)
        if rho_t > 5:
            r = (((rho_t - 4) * (rho_t - 2) * rho_inf)
                 / ((rho_inf - 4) * (rho_inf - 2) * rho_t)) ** 0.5
            torch._foreach_addcdiv_(ws, states["moment1"],
                                    self._sqrt_v_hat(states["moment2"], bc2),
                                    value=-lr * r / bc1)
        else:
            torch._foreach_add_(ws, states["moment1"], alpha=-lr / bc1)


__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "RMSProp", "Adadelta", "Adamax", "Lamb", "NAdam", "RAdam"]
