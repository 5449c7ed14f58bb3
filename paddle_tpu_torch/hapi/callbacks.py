"""hapi training callbacks (counterpart of
``paddle_tpu/hapi/callbacks.py``, the JAX package's code): the
``Callback`` base with its on_{train,eval}_{begin,end},
on_epoch_{begin,end} and on_{train,eval}_batch_{begin,end} hooks,
``CallbackList``, and the built-ins ``ModelCheckpoint``,
``EarlyStopping``, ``LRScheduler`` and ``ReduceLROnPlateau``, driven by
``Model.fit``/``evaluate``.
"""
from __future__ import annotations

import math
import numbers
from typing import List, Optional

import numpy as np

__all__ = ["Callback", "CallbackList", "ModelCheckpoint", "EarlyStopping",
           "LRScheduler", "ReduceLROnPlateau"]


def _scalar(logs, key):
    """Pull a numeric metric out of a logs dict (values may be scalars or
    one-element lists, e.g. evaluate()'s {"loss": [v]})."""
    value = (logs or {}).get(key)
    if isinstance(value, (list, tuple, np.ndarray)):
        arr = np.asarray(value).ravel()
        if arr.size != 1:
            return None
        value = float(arr[0])
    return value if isinstance(value, numbers.Number) else None


class Callback:
    """Base callback (reference callbacks.py Callback)."""

    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = dict(params or {})

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def __getattr__(self, name):
        if not name.startswith("on_"):
            raise AttributeError(name)

        def fan_out(*args, **kwargs):
            for c in self.callbacks:
                getattr(c, name)(*args, **kwargs)

        return fan_out


class ModelCheckpoint(Callback):
    """Save the parameters every ``save_freq`` epochs and at the end
    (reference callbacks.py ModelCheckpoint).

    **Manager mode** (fault tolerance): pass ``manager`` (a
    :class:`paddle_tpu_torch.fault.CheckpointManager`) to save the full
    train state (model, optimizer, optional GradScaler, epoch and step
    counters) atomically with rotation, every ``save_freq`` epochs and
    (with ``save_steps=N``) every N global steps, so
    ``Model.fit(resume=...)`` restarts step-granularly after preemption.
    With ``restore_on_nonfinite=True`` a diverged step (non-finite loss)
    rolls the model and optimizer back to the last verifiable checkpoint
    instead of training on."""

    def __init__(self, save_freq=1, save_dir=None, manager=None,
                 save_steps=None, scaler=None,
                 restore_on_nonfinite=False):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir
        self.manager = manager
        self.save_steps = save_steps
        self.scaler = scaler
        self.restore_on_nonfinite = restore_on_nonfinite
        self.restored_nonfinite = 0
        self._epoch = 0
        self._epoch_began = False
        if restore_on_nonfinite and manager is None:
            raise ValueError("restore_on_nonfinite requires manager=")
        if save_steps is not None and manager is None:
            raise ValueError("save_steps requires manager=")

    def _save_state(self, epoch, step_in_epoch=None):
        from ..fault import capture_train_state
        state = capture_train_state(network=self.model.network,
                                    optimizer=self.model._optimizer,
                                    scaler=self.scaler)
        meta = {"epoch_complete": step_in_epoch is None}
        if step_in_epoch is not None:
            meta["step_in_epoch"] = int(step_in_epoch)
        self.manager.save(state, step=self.model._global_step,
                          epoch=int(epoch), meta=meta)

    def on_train_begin(self, logs=None):
        # a reused callback must not carry a previous fit's epoch counter
        # into this run's on_train_end guard
        self._epoch = 0
        self._epoch_began = False

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._epoch_began = True

    def on_train_batch_end(self, step, logs=None):
        if self.manager is None:
            return
        if self.restore_on_nonfinite:
            loss = _scalar(logs, "loss")
            if loss is not None and not math.isfinite(loss):
                from ..fault import restore_train_state
                out = self.manager.restore()
                if out is not None:
                    restore_train_state(
                        out[0], network=self.model.network,
                        optimizer=self.model._optimizer,
                        scaler=self.scaler)
                    self.restored_nonfinite += 1
                return
        if self.save_steps and \
                self.model._global_step % self.save_steps == 0:
            self._save_state(self._epoch, step_in_epoch=step)

    def on_epoch_end(self, epoch, logs=None):
        if (epoch + 1) % max(self.save_freq, 1) != 0:
            return
        if self.manager is not None:
            self._save_state(epoch)
        elif self.save_dir:
            self.model.save(f"{self.save_dir}/{epoch}")

    def on_train_end(self, logs=None):
        if self.manager is not None:
            # only if this fit trained: a fully resumed run (start_epoch
            # == epochs) must not overwrite the newest checkpoint's meta
            # with a stale epoch counter
            if self._epoch_began:
                self._save_state(self._epoch)   # idempotent if epoch-saved
        elif self.save_dir:
            self.model.save(f"{self.save_dir}/final")


class EarlyStopping(Callback):
    """Stop when ``monitor`` stops improving (reference callbacks.py
    EarlyStopping). Sets model.stop_training, honored by Model.fit."""

    def __init__(self, monitor="loss", mode="auto", patience=0,
                 verbose=1, min_delta=0, baseline=None,
                 save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode not in ("auto", "min", "max"):
            mode = "auto"
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.wait = 0
        self.best = None
        self.stopped_epoch = -1

    def _improved(self, value):
        if self.best is None:
            return True
        if self.mode == "min":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.best = self.baseline

    def on_eval_end(self, logs=None):
        value = _scalar(logs, self.monitor)
        if value is None:
            return
        if self._improved(value):
            self.best = value
            self.wait = 0
            save_dir = self.params.get("save_dir")
            if self.save_best_model and save_dir:
                self.model.save(f"{save_dir}/best_model")
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print(f"[EarlyStopping] no {self.monitor} improvement "
                          f"for {self.wait} evals; stopping")

    def on_epoch_end(self, epoch, logs=None):
        if getattr(self.model, "stop_training", False) \
                and self.stopped_epoch < 0:
            self.stopped_epoch = epoch


class LRScheduler(Callback):
    """Step the optimizer's LR scheduler (reference callbacks.py
    LRScheduler: by_step or by_epoch)."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        if by_step and by_epoch:
            raise ValueError("by_step and by_epoch are mutually exclusive")
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s is not None:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s is not None:
                s.step()


class ReduceLROnPlateau(Callback):
    """Hook the ReduceOnPlateau scheduler to eval metrics (reference
    callbacks.py ReduceLROnPlateau-style behavior via the optimizer's
    scheduler)."""

    def __init__(self, monitor="loss"):
        super().__init__()
        self.monitor = monitor

    def on_eval_end(self, logs=None):
        value = _scalar(logs, self.monitor)
        if value is None:
            return
        opt = getattr(self.model, "_optimizer", None)
        sched = getattr(opt, "_learning_rate", None)
        from ..optimizer.lr import ReduceOnPlateau as _ROP
        if isinstance(sched, _ROP):
            sched.step(value)  # plateau scheduler consumes the metric
        # any other scheduler: do nothing — passing the metric as an
        # epoch number would silently corrupt its schedule
