"""DataLoader with worker processes (counterpart of
``paddle_tpu/io/dataloader.py``).

The JAX package's architecture: one index queue a worker, a shared
result queue and an in-order reorder buffer, ``fork`` workers, numpy
batches across the process boundary. A worker never touches the card:
it collates numpy arrays (``np.stack``; the JAX package's native
collate has no counterpart) and, for ``Tensor`` samples, a ``Tensor``
over a CPU ``torch.Tensor``. The conversion to Tensors on the loader's
device (the current device when it was built) happens at the consumer
edge (``_to_output``), in the main process. An iterator made with
``host=True`` (what ``hapi.Model.fit`` hands its ``DevicePrefetcher``)
yields host Tensors instead, pinned when the device is the card, and
the prefetcher copies them.

Teardown: exhaustion, ``close()``, garbage collection and interpreter
exit each stop the workers (``weakref.finalize``), so an exception in
the consumer's loop leaves no orphaned worker behind.
"""
from __future__ import annotations

import itertools
import multiprocessing as mp
import queue as queue_mod
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from ..core.place import current_device, resolve_device
from ..core.tensor import Tensor, as_tensor
from .dataset import IterableDataset
from .sampler import BatchSampler

_worker_info = None


@dataclass
class WorkerInfo:
    id: int
    num_workers: int
    dataset: object
    seed: int = 0


def get_worker_info():
    return _worker_info


def default_collate_fn(batch):
    """Stack samples into batched numpy arrays (Tensors for Tensor
    samples, stacked on the CPU inside a worker), keeping the sample's
    structure."""
    sample = batch[0]
    if isinstance(sample, Tensor):
        data = [b._data.detach() for b in batch]
        if _worker_info is not None:
            data = [d.cpu() for d in data]
        return Tensor(torch.stack(data))
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn(list(items))
                            for items in zip(*batch))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return batch


def _worker_loop(dataset, index_queue, data_queue, collate_fn, worker_id,
                 num_workers, init_fn):
    global _worker_info
    _worker_info = WorkerInfo(worker_id, num_workers, dataset)
    if init_fn is not None:
        init_fn(worker_id)
    while True:
        item = index_queue.get()
        if item is None:
            break
        batch_idx, indices = item
        try:
            samples = [dataset[i] for i in indices]
            data_queue.put((batch_idx, collate_fn(samples), None))
        except Exception as e:  # propagate worker errors to the consumer
            import traceback
            data_queue.put((batch_idx, None,
                            f"{e}\n{traceback.format_exc()}"))


class _SingleProcessIter:
    def __init__(self, loader, host=False):
        self._loader = loader
        self._host = host
        self._sampler_iter = iter(loader.batch_sampler)

    def __iter__(self):
        return self

    def __next__(self):
        indices = next(self._sampler_iter)
        samples = [self._loader.dataset[i] for i in indices]
        return self._loader._to_output(self._loader.collate_fn(samples),
                                       self._host)


class _IterableDatasetIter:
    def __init__(self, loader, host=False):
        self._loader = loader
        self._host = host
        self._it = iter(loader.dataset)

    def __iter__(self):
        return self

    def __next__(self):
        size = self._loader.batch_size
        batch = list(itertools.islice(self._it, size))
        if not batch or (self._loader.drop_last and len(batch) < size):
            raise StopIteration
        return self._loader._to_output(self._loader.collate_fn(batch),
                                       self._host)


def _shutdown_workers(workers, index_queues):
    """Join, else terminate, the worker processes (idempotent).
    Module-level, so a ``weakref.finalize`` runs it at garbage collection
    and at interpreter exit without keeping the iterator alive."""
    for q in index_queues:
        try:
            q.put_nowait(None)
        except Exception:
            pass
    for w in workers:
        try:
            w.join(timeout=2)
            if w.is_alive():
                w.terminate()
                w.join(timeout=2)
        except Exception:
            pass


class _MultiProcessIter:
    def __init__(self, loader, host=False):
        self._loader = loader
        self._host = host
        self._num_workers = loader.num_workers
        self._sampler_iter = iter(loader.batch_sampler)
        ctx = mp.get_context("fork")
        self._index_queues = [ctx.Queue() for _ in range(self._num_workers)]
        self._data_queue = ctx.Queue()
        self._workers = []
        for wid in range(self._num_workers):
            w = ctx.Process(
                target=_worker_loop,
                args=(loader.dataset, self._index_queues[wid],
                      self._data_queue, loader.collate_fn, wid,
                      self._num_workers, loader.worker_init_fn),
                daemon=True)
            w.start()
            self._workers.append(w)
        self._finalizer = weakref.finalize(
            self, _shutdown_workers, self._workers, self._index_queues)
        self._send_idx = 0
        self._rcvd_idx = 0
        self._reorder = {}
        self._outstanding = 0
        self._exhausted = False
        self._shutdown = False
        for _ in range(2 * self._num_workers):   # two batches a worker
            self._dispatch()

    def _dispatch(self):
        if self._exhausted:
            return
        try:
            indices = next(self._sampler_iter)
        except StopIteration:
            self._exhausted = True
            return
        self._index_queues[self._send_idx % self._num_workers].put(
            (self._send_idx, indices))
        self._send_idx += 1
        self._outstanding += 1

    def __iter__(self):
        return self

    def __next__(self):
        if self._outstanding == 0:
            self._teardown()
            raise StopIteration
        while self._rcvd_idx not in self._reorder:
            # a bounded get and a liveness check: a dead worker must not
            # hang the consumer
            try:
                batch_idx, data, err = self._data_queue.get(timeout=5.0)
            except queue_mod.Empty:
                dead = [w.pid for w in self._workers if not w.is_alive()]
                if dead:
                    self._teardown()
                    raise RuntimeError(
                        f"DataLoader worker(s) {dead} exited unexpectedly")
                continue
            if err is not None:
                self._teardown()
                raise RuntimeError(f"DataLoader worker failed:\n{err}")
            self._reorder[batch_idx] = data
        data = self._reorder.pop(self._rcvd_idx)
        self._rcvd_idx += 1
        self._outstanding -= 1
        self._dispatch()
        return self._loader._to_output(data, self._host)

    def _teardown(self):
        if self._shutdown:
            return
        self._shutdown = True
        self._finalizer()

    #: the shutdown a wrapping DevicePrefetcher calls on its own close
    close = _teardown

    @property
    def workers_alive(self) -> int:
        return sum(w.is_alive() for w in self._workers)

    def __del__(self):
        self._teardown()


class DataLoader:
    """Batches of ``dataset`` (``batch_size``, ``shuffle``, ``drop_last``
    or a ``batch_sampler``), collated by ``collate_fn``, in this process
    (``num_workers=0``) or in ``num_workers`` forked workers. Batches
    come out as Tensors on the current device at construction (or
    ``places``)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.worker_init_fn = worker_init_fn
        self.use_shared_memory = use_shared_memory
        self.return_list = return_list
        if isinstance(places, (list, tuple)):
            places = places[0] if places else None
        self.device = (current_device() if places is None else
                       places.torch_device() if hasattr(places,
                                                        "torch_device")
                       else resolve_device(places))
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size",
                                      batch_size)
        elif not isinstance(dataset, IterableDataset):
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
        else:
            self.batch_sampler = None

    def _to_output(self, data, host=False):
        """numpy -> Tensor at the consumer edge: on the loader's device,
        or with ``host`` on the CPU (pinned when the device is the card),
        for a prefetcher to copy. Integer data lands as int32, as the
        JAX package's (and ``to_tensor``'s)."""
        if isinstance(data, np.ndarray):
            if not host:
                return as_tensor(data, device=self.device)
            t = as_tensor(data, device="cpu")._data
            return Tensor(t.pin_memory() if self.device.type == "cuda"
                          else t)
        if isinstance(data, Tensor):
            d = data._data
            if host:
                on_host = d.cpu()
                return Tensor(on_host.pin_memory()
                              if self.device.type == "cuda" else on_host)
            return data if d.device == self.device else \
                Tensor(d.to(self.device))
        if isinstance(data, (list, tuple)):
            return type(data)(self._to_output(d, host) for d in data)
        if isinstance(data, dict):
            return {k: self._to_output(v, host) for k, v in data.items()}
        return data

    def iter(self, host: bool = False):
        """An iterator over the batches; ``host=True`` leaves them on the
        host for a ``DevicePrefetcher``."""
        if isinstance(self.dataset, IterableDataset):
            return _IterableDatasetIter(self, host)
        if self.num_workers == 0:
            return _SingleProcessIter(self, host)
        return _MultiProcessIter(self, host)

    def __iter__(self):
        return self.iter()

    def __len__(self):
        if self.batch_sampler is None:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)
