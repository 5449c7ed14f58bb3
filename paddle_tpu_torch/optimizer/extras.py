"""ASGD, Rprop and LBFGS (counterpart of ``paddle_tpu/optimizer/extras.py``),
with the JAX package's update rules and state names.

ASGD and Rprop update all parameters of a group with multi-tensor torch
ops, as the port's other optimizers do; ASGD's ring buffer index stays
on the device (no host read a step). LBFGS is host-driven by contract:
the closure is Python that the optimizer re-runs, and the convergence
tests and the line search read scalars. Its algorithm is the JAX
package's (the two-loop recursion over at most ``history_size`` pairs, a
pair kept when s . y > 1e-10, a backtracking-then-lengthening strong
Wolfe search), not ``torch.optim.LBFGS``'s, whose line search differs.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from ..core.tensor import Tensor, _payload, graph_break
from .optimizer import Optimizer

__all__ = ["ASGD", "Rprop", "LBFGS"]


class ASGD(Optimizer):
    """Stochastic average gradient: d = d - y_i + g, y_i = g,
    w -= lr * d / min(m + 1, batch_num), i = m % batch_num; ``ys`` holds
    the last ``batch_num`` gradients of a parameter, ``m`` its count of
    steps. ``weight_decay`` is folded into g."""

    _state_names = ["d", "ys", "m"]

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._n = int(batch_num)

    def _init_state(self, p):
        return {"d": torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device),
                "ys": torch.zeros((self._n,) + tuple(p.shape),
                                  dtype=torch.float32, device=p.device),
                "m": torch.zeros((), dtype=torch.int32, device=p.device)}

    def _state_from_checkpoint(self, state, arr, p):
        return arr.to(torch.int32) if state == "m" else arr

    def _update(self, ws, gs, states, lr, step, wd_flags):
        gs = self._apply_decay(ws, gs, wd_flags)
        for i, (w, g) in enumerate(zip(ws, gs)):
            d, ys, m = states["d"][i], states["ys"][i], states["m"][i]
            idx = (m % self._n).long().reshape(1)
            d.sub_(ys.index_select(0, idx)[0]).add_(g)
            ys.index_copy_(0, idx, g[None])
            denom = torch.clamp(m + 1, max=self._n).to(w.dtype)
            w.sub_(lr * d / denom)
            m.add_(1)


class Rprop(Optimizer):
    """Resilient backprop: each weight's step size grows by ``etas[1]``
    when its gradient keeps its sign and shrinks by ``etas[0]`` when the
    sign flips (that step is skipped and its gradient forgotten), within
    ``learning_rate_range``; w -= sign(g) * step size. Step sizes start at
    the learning rate."""

    _state_names = ["prev_grad", "step_size"]

    def __init__(self, learning_rate=0.001,
                 learning_rate_range=(1e-5, 50.0), parameters=None,
                 etas=(0.5, 1.2), grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._lr_min, self._lr_max = map(float, learning_rate_range)
        self._etam, self._etap = map(float, etas)

    def _init_state(self, p):
        return {"prev_grad": torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device),
                "step_size": torch.full(p.shape, float(self.get_lr()),
                                        dtype=torch.float32,
                                        device=p.device)}

    def _update(self, ws, gs, states, lr, step, wd_flags):
        for i, (w, g) in enumerate(zip(ws, gs)):
            prev, size = states["prev_grad"][i], states["step_size"][i]
            sign = torch.sign(g * prev)
            factor = torch.where(sign > 0, self._etap,
                                 torch.where(sign < 0, self._etam, 1.0))
            size.copy_(torch.clamp(size * factor, self._lr_min,
                                   self._lr_max))
            g_eff = torch.where(sign < 0, 0.0, g)
            w.sub_(torch.sign(g_eff) * size)
            prev.copy_(g_eff)


class LBFGS(Optimizer):
    """Limited-memory BFGS with the closure API: ``step(closure)``, where
    ``closure()`` returns the loss (the optimizer runs its backward).
    Up to ``max_iter`` iterations a step, each along the two-loop
    recursion's direction; ``line_search_fn='strong_wolfe'`` picks the
    step length by the Wolfe search, otherwise it is the learning rate.
    Returns the last loss."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError(f"LBFGS: unknown line_search_fn "
                             f"{line_search_fn!r}")
        self._max_iter = max_iter
        self._max_eval = max_eval or max_iter * 5 // 4
        self._tol_grad = tolerance_grad
        self._tol_change = tolerance_change
        self._history = int(history_size)
        self._line_search = line_search_fn
        self._s: List[torch.Tensor] = []
        self._y: List[torch.Tensor] = []

    # ------------------------------------------------------- flat helpers
    def _params(self) -> List[torch.Tensor]:
        return [p for p in self._parameter_list if p.requires_grad]

    @staticmethod
    def _flat(tensors) -> torch.Tensor:
        return torch.cat([t.reshape(-1).float() for t in tensors])

    @torch.no_grad()
    def _set_flat(self, vec: torch.Tensor):
        off = 0
        for p in self._params():
            n = p.numel()
            p.copy_(vec[off:off + n].reshape(p.shape).to(p.dtype))
            off += n

    def _eval(self, closure):
        with torch.enable_grad():
            loss = closure()
            loss.backward()
        grads = self._flat([p.grad if p.grad is not None
                            else torch.zeros_like(p, dtype=torch.float32)
                            for p in self._params()])
        self.clear_grad()
        return float(_payload(loss).detach().float()), grads

    def _direction(self, g: torch.Tensor) -> torch.Tensor:
        """Two-loop recursion over the stored curvature pairs."""
        q = -g
        alphas = []
        for s, y in zip(reversed(self._s), reversed(self._y)):
            rho = 1.0 / torch.dot(y, s)
            a = rho * torch.dot(s, q)
            q = q - a * y
            alphas.append((a, rho, s, y))
        if self._s:
            s, y = self._s[-1], self._y[-1]
            q = q * (torch.dot(s, y) / torch.dot(y, y))
        for a, rho, s, y in reversed(alphas):
            b = rho * torch.dot(y, q)
            q = q + (a - b) * s
        return q

    def _wolfe(self, closure, x0, d, f0, g0, lr):
        """Halve t until the sufficient-decrease condition holds, lengthen
        it by 1.5 until the curvature condition does; 20 probes at most."""
        c1, c2 = 1e-4, 0.9
        dg0 = float(torch.dot(g0, d))
        t = lr
        for _ in range(20):
            self._set_flat(x0 + t * d)
            f, g = self._eval(closure)
            if f > f0 + c1 * t * dg0:
                t *= 0.5
                continue
            if abs(float(torch.dot(g, d))) > c2 * abs(dg0):
                t *= 1.5
                continue
            return t, f, g
        self._set_flat(x0 + t * d)
        f, g = self._eval(closure)
        return t, f, g

    def step(self, closure: Optional[Callable] = None):
        if closure is None:
            raise RuntimeError("LBFGS.step needs a closure that returns "
                               "the loss")
        graph_break("LBFGS.step()")
        lr = float(self.get_lr())
        f, g = self._eval(closure)
        with torch.no_grad():
            x = self._flat(self._params())
        evals = 1
        for _ in range(self._max_iter):
            if float(g.abs().max()) <= self._tol_grad:
                break
            d = self._direction(g)
            if self._line_search == "strong_wolfe":
                t, f_new, g_new = self._wolfe(closure, x, d, f, g, lr)
            else:
                t = lr
                self._set_flat(x + t * d)
                f_new, g_new = self._eval(closure)
            evals += 1
            x_new = x + t * d
            s = x_new - x
            ygrad = g_new - g
            if float(torch.dot(s, ygrad)) > 1e-10:
                self._s.append(s)
                self._y.append(ygrad)
                if len(self._s) > self._history:
                    self._s.pop(0)
                    self._y.pop(0)
            small_step = float(s.abs().max()) <= self._tol_change
            x, f_old, f, g = x_new, f, f_new, g_new
            if small_step or abs(f - f_old) <= self._tol_change:
                break
            if evals >= self._max_eval:
                break
        self._set_flat(x)
        return Tensor(torch.tensor(f, dtype=torch.float32, device=x.device))
