"""Dynamic loss scaling (counterpart of ``paddle_tpu/amp/grad_scaler.py``).

bf16 needs no loss scaling; fp16 does: scale the loss, unscale the
gradients before the step, skip a step whose gradients hold inf or nan,
and grow or shrink the scale on the usual schedule.
"""
from __future__ import annotations

import torch


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=65536.0,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Multiply every gradient by 1 / scale in fp32 and write it back
        in the gradient's own dtype (as the JAX package does), with one
        multi-tensor pass a device that also flags any inf or nan (torch's
        ``_amp_foreach_non_finite_check_and_unscale_``: it tests the
        values before the product, which for a scale of at least 1 flags
        the same steps). One host sync decides the step."""
        if not self._enable or self._unscaled:
            return
        by_device = {}
        for p in optimizer._parameter_list:
            if p.grad is not None:
                by_device.setdefault(p.grad.device, []).append(p.grad)
        found = []
        for device, grads in by_device.items():
            flag = torch.zeros(1, device=device)
            torch._amp_foreach_non_finite_check_and_unscale_(
                grads, flag, torch.full((1,), 1.0 / self._scale,
                                        device=device))
            found.append(flag)
        # the one host sync: step or skip is decided on the host
        self._found_inf = bool(torch.cat([f.cpu() for f in found]).any()) \
            if found else False
        self._unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._update_scale()
        self._unscaled = False

    def update(self):
        """No-op hook for API parity; the scale moves in ``step``."""

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        optimizer.clear_grad()

    def _update_scale(self):
        if not self._dynamic:
            self._found_inf = False
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n_nan_or_inf:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
            "good_steps": self._good_steps,
            "bad_steps": self._bad_steps,
            "use_dynamic_loss_scaling": self._dynamic,
        }

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)
        self._dynamic = state.get("use_dynamic_loss_scaling", self._dynamic)

    set_state_dict = load_state_dict


AmpScaler = GradScaler

__all__ = ["GradScaler", "AmpScaler"]
