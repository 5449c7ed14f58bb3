"""hapi ``Model``: the high-level train/eval/predict facade (counterpart
of ``paddle_tpu/hapi/model.py``, the JAX package's code).

``prepare`` takes the optimizer, loss and metrics (``amp_configs`` is
accepted and ignored, as in the JAX package); ``train_batch`` is plain
eager dispatch, materializes the loss and skips the optimizer step when
it is not finite; ``fit`` drives a ``DataLoader`` over the training
data, wraps it in a ``DevicePrefetcher`` (``FLAGS_prefetch``: the loader
yields host batches and the prefetcher copies them to the card on its
side stream), and feeds the goodput ledger, the sentinel and the
supervisor seam a step at a time; ``evaluate`` and ``predict`` run
their loaders directly. Batches land on the current device (the card
unless ``paddle.set_device("cpu")``). A network wrapped with
``jit.to_static`` before the ``Model`` is built runs its recorded
programs, as in the JAX package; training and evaluation are two
signatures (the network's ``training`` flags are part of the key).

``save``/``load`` write and read ``.pdparams``/``.pdopt`` files in the
JAX package's v2 format (``framework/io.py``), ``fit(save_dir=...)``
saves every ``save_freq`` epochs, and ``fit(resume=manager)`` restores
the newest verifiable train state of a ``fault.CheckpointManager`` and
skips the epochs and steps it had already trained. A world larger than
one process resumes through the supervisor's consensus rewind, which is
still to port: it raises ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

from ..core.tensor import Tensor
from ..fault import inject as _inject
from ..observability import metrics as _metrics

_m_skipped = _metrics.counter(
    "paddle_tpu_train_nonfinite_skipped_total",
    "Optimizer steps skipped because the loss went non-finite "
    "(graceful degradation instead of poisoning the weights).")


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics: List = []
        self.stop_training = False
        #: train batches run so far; persisted by manager-mode
        #: ModelCheckpoint and restored by fit(resume=...)
        self._global_step = 0
        #: optimizer steps skipped on a non-finite loss (this run)
        self._nonfinite_steps = 0

    # ------------------------------------------------------------- prepare
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        return self

    # ------------------------------------------------------- batch methods
    def _compute_loss(self, outputs, labels):
        outs = _to_list(outputs)
        labs = _to_list(labels)
        if self._loss is None:
            raise RuntimeError("call prepare(loss=...) first")
        return self._loss(*outs, *labs)

    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        outputs = self.network(*_to_list(inputs))
        loss = self._compute_loss(outputs, labels)
        if _inject.fire("grads.nan_at_step",
                        step=self._global_step) is not None:
            loss = loss * float("nan")   # deterministic divergence for tests
        loss.backward()
        # the loss is read here, before the optimizer step: a non-finite
        # loss must never reach the weights
        loss_val = float(loss.numpy())
        if update and self._optimizer is not None:
            if math.isfinite(loss_val):
                self._optimizer.step()
            else:
                self._nonfinite_steps += 1
                _m_skipped.inc()
            self._optimizer.clear_grad()
        self._global_step += 1
        metrics = self._update_metrics(outputs, labels)
        return ([loss_val], metrics) if metrics else [loss_val]

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        outputs = self.network(*_to_list(inputs))
        loss = self._compute_loss(outputs, labels)
        metrics = self._update_metrics(outputs, labels)
        return ([float(loss.numpy())], metrics) if metrics else \
            [float(loss.numpy())]

    def predict_batch(self, inputs):
        self.network.eval()
        outputs = self.network(*_to_list(inputs))
        return [o.numpy() if isinstance(o, Tensor) else o
                for o in _to_list(outputs)]

    def _update_metrics(self, outputs, labels):
        res = []
        for m in self._metrics:
            correct = m.compute(*_to_list(outputs), *_to_list(labels))
            m.update(*[np.asarray(c.numpy() if isinstance(c, Tensor) else c)
                       for c in _to_list(correct)])
            res.append(m.accumulate())
        return res

    # ------------------------------------------------------------ fit loop
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, resume=None):
        """Train for ``epochs`` over ``train_data`` (a Dataset or a
        DataLoader); returns the epochs' mean train losses.

        ``resume``: a :class:`paddle_tpu_torch.fault.CheckpointManager`;
        restores the model and optimizer (and a GradScaler, when a
        manager-mode ModelCheckpoint callback carries one) from the newest
        verifiable checkpoint and fast-forwards the epoch and step
        counters, falling back past a corrupt newest checkpoint."""
        from ..core import flags as _flags
        from ..io import DataLoader
        from ..io.prefetch import DevicePrefetcher
        from ..observability import goodput as _goodput
        from .callbacks import CallbackList, _scalar
        loader = train_data
        if not isinstance(train_data, DataLoader):
            loader = DataLoader(train_data, batch_size=batch_size,
                                shuffle=shuffle, drop_last=drop_last,
                                num_workers=num_workers)
        cbks = CallbackList(_to_list(callbacks))
        cbks.set_model(self)
        cbks.set_params({"epochs": epochs, "batch_size": batch_size,
                         "verbose": verbose, "save_dir": save_dir,
                         "metrics": [m.name() for m in self._metrics]})
        # begun before the resume, so auto_resume's rewind lands in this run
        _goodput.ledger().run_begin()
        start_epoch, skip_steps = 0, 0
        if resume is not None:
            start_epoch, skip_steps = self._auto_resume(resume,
                                                        cbks.callbacks,
                                                        verbose)
        use_prefetch = bool(_flags.get_flag("prefetch"))
        self.stop_training = False
        history = []
        cbks.on_train_begin()
        for epoch in range(start_epoch, epochs):
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            losses = []
            # the next batch is fetched and copied to the card on a
            # background thread while train_batch runs; closing the
            # prefetcher stops the loader's workers
            batches = (DevicePrefetcher(loader.iter(host=True),
                                        device=loader.device)
                       if use_prefetch else loader)
            try:
                self._fit_epoch(batches, epoch, start_epoch, skip_steps,
                                losses, cbks, verbose, log_freq)
            finally:
                if isinstance(batches, DevicePrefetcher):
                    batches.close()
            # an epoch the resume skipped whole reports no loss
            epoch_logs = {}
            if losses:
                epoch_logs = {"loss": float(np.mean(losses))}
                history.append(epoch_logs["loss"])
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                eval_res = self.evaluate(eval_data, batch_size=batch_size,
                                         verbose=verbose,
                                         callbacks=cbks.callbacks)
                # 'loss' stays the train loss; eval results are namespaced
                for k in eval_res:
                    v = _scalar(eval_res, k)
                    epoch_logs[f"eval_{k}"] = (v if v is not None
                                               else eval_res[k])
            if save_dir and (epoch + 1) % max(save_freq, 1) == 0:
                self.save(f"{save_dir}/epoch_{epoch}")
            cbks.on_epoch_end(epoch, epoch_logs)
            if self.stop_training:
                break
        cbks.on_train_end({"loss": history[-1] if history else None})
        return history

    def _fit_epoch(self, batches, epoch, start_epoch, skip_steps, losses,
                   cbks, verbose, log_freq):
        """One epoch's step loop over ``batches`` (a DevicePrefetcher or
        the loader)."""
        from ..fault import supervisor as _fault_sup
        from ..observability import goodput as _goodput
        from ..observability import sentinel as _sentinel
        led = _goodput.ledger()
        snt = _sentinel.get()
        for step, batch in enumerate(batches):
            if epoch == start_epoch and step < skip_steps:
                continue   # step-granular resume: already trained
            _fault_sup.tick(self._global_step)
            led.step_begin()
            cbks.on_train_batch_begin(step)
            batch = _to_list(batch)
            xs, ys = batch[:-1], batch[-1:]
            out = self.train_batch(xs, ys)
            loss = out[0][0] if isinstance(out, tuple) else out[0]
            losses.append(loss)
            snt.observe_step(led.step_end(step=self._global_step),
                             loss=loss, step=self._global_step)
            if verbose and log_freq and step % log_freq == 0:
                msg = f"epoch {epoch} step {step} loss {loss:.4f}"
                for m, v in zip(self._metrics,
                                out[1] if isinstance(out, tuple) else []):
                    msg += f" {m.name()}={v}"
                print(msg)
            cbks.on_train_batch_end(step, {"loss": loss})

    def _auto_resume(self, manager, callbacks, verbose):
        """Restore train state from ``manager`` and translate its meta
        into (start_epoch, steps to skip in that epoch). A world of more
        than one process (the launcher's ``WORLD_SIZE``) would resume
        through the supervisor's consensus rewind, still to port."""
        from ..fault import auto_resume
        from ..fault import supervisor as _fault_sup
        from ..observability.reqtrace import rank_world
        scaler = None
        for c in callbacks:
            scaler = getattr(c, "scaler", None) or scaler
        if scaler is not None:
            _fault_sup.register_scaler(scaler)
        if rank_world()[1] > 1:
            raise NotImplementedError(
                "later slice: fit(resume=...) in a world of more than one "
                "process waits for the port of supervisor.consensus_resume")
        meta = auto_resume(manager, network=self.network,
                           optimizer=self._optimizer, scaler=scaler)
        if meta is None:
            return 0, 0
        self._global_step = int(meta.get("step", 0))
        epoch = meta.get("epoch")
        if epoch is None:
            return 0, 0
        if meta.get("epoch_complete", True):
            start_epoch, skip_steps = int(epoch) + 1, 0
        else:
            start_epoch = int(epoch)
            skip_steps = int(meta.get("step_in_epoch", -1)) + 1
        if verbose:
            print(f"[resume] restored step {self._global_step} "
                  f"(epoch {start_epoch}, skipping {skip_steps} "
                  f"completed steps; fallback depth "
                  f"{manager.last_fallback_depth})")
        return start_epoch, skip_steps

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None):
        from ..io import DataLoader
        from .callbacks import CallbackList
        loader = eval_data
        if not isinstance(eval_data, DataLoader):
            loader = DataLoader(eval_data, batch_size=batch_size,
                                num_workers=num_workers)
        cbks = CallbackList(_to_list(callbacks))
        cbks.set_model(self)
        cbks.on_eval_begin()
        for m in self._metrics:
            m.reset()
        losses = []
        for step, batch in enumerate(loader):
            cbks.on_eval_batch_begin(step)
            batch = _to_list(batch)
            xs, ys = batch[:-1], batch[-1:]
            out = self.eval_batch(xs, ys)
            loss = out[0][0] if isinstance(out, tuple) else out[0]
            losses.append(loss)
            cbks.on_eval_batch_end(step, {"loss": loss})
        result = {"loss": [float(np.mean(losses))]}
        for m in self._metrics:
            result[m.name()] = m.accumulate()
        if verbose:
            print("eval:", result)
        cbks.on_eval_end(result)
        return result

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None):
        from ..io import DataLoader
        loader = test_data
        if not isinstance(test_data, DataLoader):
            loader = DataLoader(test_data, batch_size=batch_size,
                                num_workers=num_workers)
        outs = []
        for batch in loader:
            batch = _to_list(batch)
            # the inputs: Model(inputs=...) decides when given; otherwise
            # one trailing label is dropped when a loss was prepared
            if self._inputs is not None:
                batch = batch[:len(_to_list(self._inputs))]
            elif self._loss is not None and len(batch) > 1:
                batch = batch[:-1]
            outs.append(self.predict_batch(batch))
        if stack_outputs and outs:
            n = len(outs[0])
            return [np.concatenate([o[i] for o in outs]) for i in range(n)]
        return outs

    # ------------------------------------------------------------ save/load
    def save(self, path, training=True):
        """``path.pdparams`` (the network's state) and, when training,
        ``path.pdopt`` (the optimizer's)."""
        from ..framework.io import save as _save
        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None and \
                hasattr(self._optimizer, "state_dict"):
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Load ``path.pdparams`` into the network and, unless
        ``reset_optimizer``, ``path.pdopt`` into the optimizer when it
        exists (``skip_mismatch`` is accepted and ignored, as in the JAX
        package: a shape mismatch raises)."""
        import os

        from ..framework.io import load as _load
        self.network.set_state_dict(_load(path + ".pdparams"))
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(opt_path) and \
                hasattr(self._optimizer, "set_state_dict"):
            self._optimizer.set_state_dict(_load(opt_path))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        from .summary import summary as _summary
        return _summary(self.network, input_size, dtypes=dtype)
