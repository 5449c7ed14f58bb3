"""The parallel environment and ``DataParallel`` (counterpart of
``paddle_tpu/distributed/parallel.py``).

The JAX package rendezvouses through ``jax.distributed`` and lets XLA
insert the gradient all-reduce. The port is the reference framework's
design: one process a card, ``init_parallel_env`` joins the
``torch.distributed`` world (NCCL on the cards; gloo only when the caller
set the CPU with ``set_device("cpu")``), and ``DataParallel`` reduces the
gradients with a reducer of its own:

* the trainable parameters, in reverse order (about the order backward
  makes their gradients), go into buckets of one dtype and device: the
  first holds up to ``last_comm_buffer_size`` MB, the others up to
  ``comm_buffer_size`` MB;
* a hook on each parameter's leaf payload
  (``register_post_accumulate_grad_hook``; a Paddle ``Parameter``'s
  payload or a ``torch.nn.Parameter``, so one reducer serves the Paddle
  API's Layers and the torch-level models) marks it ready; a bucket whose
  parameters are all ready is flattened, divided by the group's size and
  all-reduced asynchronously, buckets always in the same order on every
  rank;
* at the end of backward (an autograd engine callback) every reduction
  is waited for and copied back into the gradients. A parameter that got
  no gradient raises there, unless ``find_unused_parameters``, which
  reduces zeros for it; ``no_sync()`` leaves the gradients local (the
  next synchronised backward reduces what they accumulated).

``DataParallel`` takes each rank's own batch (a ``DistributedBatchSampler``
gives it), as the reference does; the JAX wrapper instead shards one
global batch every process holds (noted in ROADMAP Queue 3).
"""
from __future__ import annotations

import atexit
import contextlib
import datetime
import gc
import os
from typing import List, Optional

import torch
import torch.distributed as dist

from ..core import place as _place
from ..core.tensor import Tensor
from ..nn.layer.layers import Layer
from . import mesh as mesh_mod
from .communication import collective as C
from .communication.group import Group, get_default_group


def _env_int(*names, default=0) -> int:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return default


class ParallelEnv:
    """Reference: python/paddle/distributed/parallel.py ParallelEnv."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def local_rank(self):
        return _env_int("LOCAL_RANK", "PADDLE_LOCAL_RANK", "PADDLE_RANK_IN_NODE")

    @property
    def dev_id(self):
        return self.local_rank

    @property
    def nranks(self):
        return self.world_size

    @property
    def device_count(self):
        return torch.cuda.device_count()

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:0")

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else []


def _master():
    """(host, port) of the rendezvous: ``MASTER_ADDR``/``MASTER_PORT``,
    else ``PADDLE_MASTER`` (host:port)."""
    host = os.environ.get("MASTER_ADDR")
    port = os.environ.get("MASTER_PORT")
    if not (host and port):
        master = os.environ.get("PADDLE_MASTER", "")
        if ":" in master:
            host, _, port = master.rpartition(":")
    return host, port


_exit_hook_registered = False


def _exit_hook():
    """At interpreter exit, while the interpreter is still whole: wait on
    the collectives issued and not waited on, then destroy every group,
    the world, the mesh and the hybrid topology, and collect the process
    groups so that their threads are joined now. Without it the process
    groups outlived the interpreter, their threads still running when
    the C++ runtime tore down, and a loaded gloo rank could end with
    "terminate called without an active exception" (SIGABRT) after its
    work was done. A no-op when the world is gone already (a caller's own
    ``destroy_process_group``)."""
    if not dist.is_initialized():
        return
    from .communication import collective as C
    from .communication.group import destroy_process_group
    try:
        C.wait_outstanding()
    finally:
        destroy_process_group()
        # the process groups unbound above are freed here, and their
        # worker and transport threads joined, while the interpreter runs
        gc.collect()


def init_parallel_env(timeout: Optional[float] = None) -> ParallelEnv:
    """Join the world (reference parallel.py:945). The rank and world size
    come from the launcher's environment (``RANK``/``WORLD_SIZE``, else
    ``PADDLE_TRAINER_ID``/``PADDLE_TRAINERS_NUM``; 0 of 1 outside a
    launcher), the rendezvous from ``MASTER_ADDR``/``MASTER_PORT`` (else
    ``PADDLE_MASTER``). On the cards: ``torch.cuda.set_device(local_rank)``
    and NCCL bound to that card, whose index becomes the default device.
    gloo only after ``set_device("cpu")``; without CUDA and without that,
    it raises. A second call returns the environment. The first
    registers an exit hook that waits on the collectives still in flight
    and destroys the groups (``_exit_hook``)."""
    if dist.is_initialized():
        return ParallelEnv()
    rank = _env_int("RANK", "PADDLE_TRAINER_ID")
    world = _env_int("WORLD_SIZE", "PADDLE_TRAINERS_NUM", default=1)
    local = _env_int("LOCAL_RANK", "PADDLE_LOCAL_RANK")
    cpu = _place.get_device() == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError(
            "init_parallel_env: CUDA is not available; call "
            "set_device('cpu') first to run the world over gloo on the CPU")
    host, port = _master()
    if world > 1 and not (host and port):
        raise RuntimeError(
            f"init_parallel_env: a world of {world} needs MASTER_ADDR and "
            f"MASTER_PORT (or PADDLE_MASTER); start it with python -m "
            f"paddle_tpu_torch.distributed.launch")
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if host and port:
        kw["init_method"] = f"tcp://{host}:{port}"
    else:                                # one process, no launcher
        kw["store"] = dist.HashStore()
    if cpu:
        dist.init_process_group("gloo", rank=rank, world_size=world, **kw)
    else:
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"init_parallel_env: local rank {local} has no card (this "
                f"host has {torch.cuda.device_count()})")
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", rank=rank, world_size=world,
                                device_id=torch.device("cuda", local), **kw)
    global _exit_hook_registered
    if not _exit_hook_registered:
        atexit.register(_exit_hook)
        _exit_hook_registered = True
    return ParallelEnv()


def get_rank(group: Optional[Group] = None) -> int:
    """This process's rank in ``group`` (default: the world); from the
    launcher's environment before ``init_parallel_env``."""
    if not dist.is_initialized():
        return _env_int("RANK", "PADDLE_TRAINER_ID")
    if group is not None:
        return group.rank
    return dist.get_rank()


def get_world_size(group: Optional[Group] = None) -> int:
    if not dist.is_initialized():
        return _env_int("WORLD_SIZE", "PADDLE_TRAINERS_NUM", default=1)
    if group is not None:
        return group.nranks
    return dist.get_world_size()


def is_initialized() -> bool:
    return dist.is_initialized()


# ---------------------------------------------------------------- wrappers
def _leaves(layers) -> List[torch.Tensor]:
    """The leaf payloads of ``layers``'s parameters (a Paddle ``Layer``
    or a ``torch.nn.Module``), in registration order."""
    return [p._data if isinstance(p, Tensor) else p
            for p in layers.parameters()]


def sync_params_buffers(layers, group: Optional[Group] = None, src_rank=None,
                        is_model_parallel: bool = False):
    """Broadcast every parameter and buffer of ``layers`` from ``src_rank``
    (default: the group's first) over ``group``; with
    ``is_model_parallel``, the parameters split over mp
    (``is_distributed``) are left alone."""
    from .fleet.mpu.mp_layers import is_split
    g = group if group is not None else get_default_group()
    if g.nranks == 1:
        return
    src = g.ranks[0] if src_rank is None else src_rank
    tensors = [p for p in _leaves(layers)
               if not (is_model_parallel and is_split(p))]
    tensors += [b._data if isinstance(b, Tensor) else b
                for b in layers.buffers() if b is not None]
    with torch.no_grad():
        for t in tensors:
            C.broadcast(t, src=src, group=g)


MB = 2 ** 20
#: ``DataParallel``'s default bucket sizes (MB), the reference's
COMM_BUFFER_SIZE = 25
LAST_COMM_BUFFER_SIZE = 1


def build_buckets(tensors, first_bytes: float, rest_bytes: float
                  ) -> List[List[torch.Tensor]]:
    """``tensors`` cut, in order, into buckets of one dtype and device:
    the first holds up to ``first_bytes``, the others up to
    ``rest_bytes`` (a tensor larger than the limit is a bucket of its
    own)."""
    buckets: List[List[torch.Tensor]] = []
    limit, size = first_bytes, 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        b = buckets[-1] if buckets else None
        if b is None or size + nbytes > limit or (
                b[0].dtype, b[0].device) != (t.dtype, t.device):
            if b is not None:
                limit = rest_bytes
            buckets.append([])
            size = 0
        buckets[-1].append(t)
        size += nbytes
    return buckets


def launch_mean(tensors: List[torch.Tensor], group: Group):
    """Start averaging ``tensors`` over ``group``: one flat copy, divided
    by the group's size, all-reduced asynchronously. Returns
    ``(flat, task)`` for ``write_back``."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat.div_(group.nranks)
    return flat, C.all_reduce(flat, group=group, sync_op=False)


def write_back(tensors: List[torch.Tensor], flat: torch.Tensor, task):
    """Wait for ``task`` and copy ``flat`` back into ``tensors``."""
    task.wait()
    offset = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


class _Reducer:
    """The bucketed, asynchronous gradient all-reduce (module docstring)."""

    def __init__(self, params: List[torch.Tensor], group: Group,
                 comm_buffer_size: float, last_comm_buffer_size: float,
                 find_unused_parameters: bool):
        self.group = group
        self.find_unused = find_unused_parameters
        self.params = [p for p in params if p.requires_grad]
        self.buckets = build_buckets(reversed(self.params),
                                     last_comm_buffer_size * MB,
                                     comm_buffer_size * MB)
        self._bucket_of = {id(p): i for i, b in enumerate(self.buckets)
                           for p in b}
        self.sync = True
        self._task = None        # the autograd graph task being reduced
        self._handles = [p.register_post_accumulate_grad_hook(self._ready)
                         for p in self.params]

    def _ready(self, p):
        if not self.sync or self.group.nranks == 1:
            return
        task = torch._C._current_graph_task_id()
        if task != self._task:
            # the first gradient of this backward. A backward that raised
            # never ran its _finalize: its state (and its launched
            # reductions, left unread) is dropped here.
            self._task = task
            self._got = [set() for _ in self.buckets]
            self._next = 0
            self._inflight = []
            torch.autograd.Variable._execution_engine.queue_callback(
                self._finalize)
        b = self._bucket_of[id(p)]
        self._got[b].add(id(p))
        self._launch_ready()

    def _launch_ready(self):
        while (self._next < len(self.buckets) and len(self._got[self._next])
               == len(self.buckets[self._next])):
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.buckets[self._next]]
            self._inflight.append(
                (self._next, *launch_mean(grads, self.group)))
            self._next += 1

    def _finalize(self):
        self._task = None
        missing = [p for b, ps in enumerate(self.buckets) for p in ps
                   if id(p) not in self._got[b]]
        if missing and not self.find_unused:
            raise RuntimeError(
                f"DataParallel: {len(missing)} parameters got no gradient "
                f"in this backward; pass find_unused_parameters=True to "
                f"reduce zeros for them")
        for b, ps in enumerate(self.buckets):
            self._got[b].update(id(p) for p in ps)
        self._launch_ready()
        for b, flat, task in self._inflight:
            for p in self.buckets[b]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            write_back([p.grad for p in self.buckets[b]], flat, task)
        self._inflight = []

    def remove(self):
        for h in self._handles:
            h.remove()
        self._handles = []


class _ParallelWrapper(Layer):
    """A wrapper over a Paddle ``Layer`` or a ``torch.nn.Module``: it
    calls it, and gives its parameters (under its own names), state dict
    and attributes."""

    def __init__(self, layers):
        super().__init__()
        if isinstance(layers, Layer):
            self._layers = layers
        else:
            object.__setattr__(self, "_layers", layers)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def parameters(self, include_sublayers: bool = True):
        return list(self._layers.parameters())

    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True):
        return self._layers.named_parameters()

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, *args, **kwargs):
        if isinstance(self._layers, Layer):
            return self._layers.set_state_dict(*args, **kwargs)
        return self._layers.load_state_dict(*args, **kwargs)

    load_state_dict = set_state_dict

    def train(self):
        self._layers.train()
        self.training = True
        return self

    def eval(self):
        self._layers.eval()
        self.training = False
        return self

    def __getattr__(self, name):
        d = self.__dict__
        if name == "_layers" or name.startswith("__"):
            return super().__getattr__(name)
        inner = d.get("_sub_layers", {}).get("_layers", d.get("_layers"))
        if inner is None:
            return super().__getattr__(name)
        return getattr(inner, name)


class DataParallel(_ParallelWrapper):
    """Data-parallel wrapper (reference parallel.py:202). Broadcasts the
    parameters and buffers from the group's first rank, then reduces the
    gradients of every backward over ``group`` (default: the mesh's
    ``dp`` group when a mesh is set, else the world) with the reducer of
    the module docstring."""

    def __init__(self, layers, strategy=None,
                 comm_buffer_size=COMM_BUFFER_SIZE,
                 last_comm_buffer_size=LAST_COMM_BUFFER_SIZE,
                 find_unused_parameters=False,
                 group: Optional[Group] = None):
        super().__init__(layers)
        if not dist.is_initialized():
            raise RuntimeError("DataParallel: call init_parallel_env() "
                               "first")
        if group is None:
            group = (mesh_mod.get_mesh().group(("dp",))
                     if mesh_mod.has_mesh() and "dp" in
                     mesh_mod.get_mesh().shape else get_default_group())
        self.group = group
        self.comm_buffer_size = comm_buffer_size
        self.last_comm_buffer_size = last_comm_buffer_size
        self.find_unused_parameters = find_unused_parameters
        sync_params_buffers(layers, group)
        self._reducer = _Reducer(_leaves(layers), group, comm_buffer_size,
                                 last_comm_buffer_size,
                                 find_unused_parameters)

    @property
    def bucket_count(self) -> int:
        return len(self._reducer.buckets)

    @contextlib.contextmanager
    def no_sync(self):
        """Backward inside the block leaves the gradients local."""
        prev = self._reducer.sync
        self._reducer.sync = False
        try:
            yield
        finally:
            self._reducer.sync = prev

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        pass
