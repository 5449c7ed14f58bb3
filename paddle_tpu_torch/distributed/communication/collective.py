"""Collective operations (counterpart of
``paddle_tpu/distributed/communication/collective.py``).

The JAX package runs each collective as a one-op ``shard_map`` program
over the group's mesh axes; the port runs it on ``torch.distributed``
(NCCL on the cards, gloo on the CPU), one process a rank. Rank r's local
tensor is shard r of the JAX global array, so the JAX collective's shard
r is rank r's result here.

The Paddle contracts: ``all_reduce``, ``broadcast``, ``reduce`` and the
receive side of ``scatter``/``reduce_scatter``/``recv`` write into the
tensor they are given (a ``torch.Tensor`` or a Paddle ``Tensor``, whose
payload is written; no gradient is recorded); ``all_gather`` and
``alltoall`` fill the list they are given. With ``sync_op=True`` a call
returns when its result is ready (it returns the tensor or list); with
``sync_op=False`` it returns a ``Task`` whose ``wait()`` makes the result
ready. ``src``/``dst``/``peer`` are global ranks and must be in the
group (``ValueError`` otherwise); a process outside the group raises too.
A group of one rank needs no communicator: its collectives are local.
Every call counts in ``paddle_tpu_collective_calls_total``,
``paddle_tpu_collective_bytes_total`` and
``paddle_tpu_collective_latency_seconds`` while metrics are on. The
last is the host's time in the call, not the collective's: on NCCL the
host only enqueues the work (``Work.wait()`` makes the caller's stream
wait, not the host), so it reads dispatch time even for ``sync_op=True``;
on gloo a synchronous call's time includes the transfer.

Each call also opens a collective flight record (``observability.flight``,
``FLAGS_flight_recorder``, on by default) before the NCCL call: a per-group
sequence number, the op, shape, dtype and bytes. The record closes when
the collective completes: on gloo when the call (or its ``Task.wait()``)
returns; on NCCL, where the host only enqueues the work, when a CUDA
event recorded after ``Task.wait()`` is first seen complete. A call that
raises closes its record with the exception's type. A rank stuck in a
collective on the card thus leaves its record open, which is what the
watchdog's cross-rank diff reads. The ``collective.desync`` fault point
(``fault.inject``) makes ``all_reduce``, ``all_gather``, ``broadcast``
and ``barrier`` skip the collective on this rank (its record is marked
``bypassed``): the desync drill. With flight recording off and no fault
armed, a call reads one dict entry for them.
"""
from __future__ import annotations

import time as _time
import weakref
from typing import List, Optional

import torch
import torch.distributed as dist

from ...core.tensor import Tensor
from ...fault import inject as _inject
from ...observability import flight as _flight
from ...observability import metrics as _metrics
from .. import mesh as mesh_mod
from .group import Group, get_default_group

_m_coll_calls = _metrics.counter(
    "paddle_tpu_collective_calls_total",
    "Collective invocations per primitive.", labelnames=("op",))
_m_coll_bytes = _metrics.counter(
    "paddle_tpu_collective_bytes_total",
    "Input payload bytes handed to each collective primitive.",
    labelnames=("op",))
_m_coll_latency = _metrics.histogram(
    "paddle_tpu_collective_latency_seconds",
    "Host wall time per collective call: its dispatch (on NCCL the host "
    "does not wait for the card, even when the call is synchronous; on "
    "gloo a synchronous call includes the transfer).", labelnames=("op",))


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT}


#: the newest collective a call returned from, for the watchdog's hang
#: report (its time only while metrics pay for clock reads)
LAST_COLLECTIVE = {"op": None, "t": 0.0}


class Task:
    """An issued collective: ``wait()`` blocks the caller's stream until
    the result is ready and finishes it (averages, copies into the
    caller's tensor or list) and closes its flight record;
    ``is_completed()``."""

    def __init__(self, works=(), finish=None, record=None,
                 on_device=False):
        self._works = [w for w in works if w is not None]
        self._finish = finish
        self._record = record
        self._on_device = on_device
        self._done = False
        if self._works:
            _outstanding.add(self)

    def wait(self, timeout=None):
        if not self._done:
            for w in self._works:
                w.wait()
            if self._finish is not None:
                self._finish()
            self._done = True
            self._works = []       # a finished work holds its communicator
            _outstanding.discard(self)
            rec, self._record = self._record, None
            if rec is not None:
                if self._on_device:
                    # the current stream now waits for the collective: an
                    # event after it completes when the collective does
                    ev = torch.cuda.Event()
                    ev.record()
                    _flight.RECORDER.end_on_device(rec, ev)
                else:
                    _flight.RECORDER.end(rec)
        return True

    def is_completed(self) -> bool:
        return self._done or all(w.is_completed() for w in self._works)


#: issued tasks not waited on yet (``wait_outstanding``)
_outstanding: "weakref.WeakSet[Task]" = weakref.WeakSet()


def wait_outstanding():
    """Wait on every issued task still alive and not waited on (the exit
    hook's first step, ``parallel._exit_hook``)."""
    for task in list(_outstanding):
        task.wait()


def _group(group: Optional[Group], what: str) -> Group:
    g = group if group is not None else get_default_group()
    if not g.is_member():
        raise ValueError(f"{what}: rank {dist.get_rank()} is not in the "
                         f"group {g.ranks}")
    return g


def _peer(g: Group, rank: int, what: str, role: str) -> int:
    if int(rank) not in g.ranks:
        raise ValueError(f"{what}: {role} rank {rank} is not in the group "
                         f"{g.ranks}")
    return int(rank)


def _data(x) -> torch.Tensor:
    return x._data if isinstance(x, Tensor) else x


def _op(op, what: str):
    if op not in (ReduceOp.SUM, ReduceOp.MAX, ReduceOp.MIN, ReduceOp.PROD,
                  ReduceOp.AVG):
        raise ValueError(f"{what}: unsupported reduce op {op!r}")
    return op


class _Call:
    """One call's metrics and flight record: begun at construction (the
    record before the NCCL call), ended at ``done``, or by the ``Task``
    the record is handed to (``_finish``). Used as a context manager
    around the call, it closes the record of a call that raises."""

    def __init__(self, name: str, payload=None, group: Optional[Group] = None):
        self.name = name
        self.t0 = _time.perf_counter() if _metrics.enabled() else None
        self.nbytes = (payload.numel() * payload.element_size()
                       if isinstance(payload, torch.Tensor) else 0)
        self.record = None
        self.on_device = False
        if _flight.enabled():
            shape = tuple(payload.shape) if isinstance(
                payload, torch.Tensor) else ()
            dtype = payload.dtype if isinstance(payload, torch.Tensor) \
                else None
            self.record = _flight.RECORDER.begin(
                int(getattr(group, "id", 0) or 0), name, shape,
                str(dtype).replace("torch.", "") if dtype is not None
                else "", self.nbytes)
            self.on_device = group is not None and group.nranks > 1 and \
                dist.get_backend(group.pg) == "nccl"

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        rec = self.record
        if exc_type is not None and rec is not None and rec["t1"] is None:
            # this rank is no longer inside the transport: an open record
            # would read as "blocked at seq N" in every later diff
            rec["raised"] = exc_type.__name__
            _flight.RECORDER.end(rec)
        return False

    def bypassed(self) -> bool:
        """``collective.desync`` armed (its ``op`` filter matching): this
        rank skips the collective; its record completes at once, marked
        ``bypassed``, while the peers block on the missing rank."""
        if not _inject._armed or _inject.fire("collective.desync",
                                              op=self.name) is None:
            return False
        if self.record is not None:
            self.record["bypassed"] = True
        return True

    def done(self, result=None):
        LAST_COLLECTIVE["op"] = self.name
        rec, self.record = self.record, None
        if rec is not None:
            _flight.RECORDER.end(rec)
        if self.t0 is not None:
            t1 = _time.perf_counter()
            LAST_COLLECTIVE["t"] = _time.monotonic()
            _m_coll_calls.inc(op=self.name)
            _m_coll_bytes.inc(self.nbytes, op=self.name)
            _m_coll_latency.observe(t1 - self.t0, op=self.name)
        return result


def _finish(sync_op: bool, works, finish, result, call=None):
    """Wrap the issued ``works`` in a ``Task`` (which takes over ``call``'s
    flight record); wait on it for a synchronous call."""
    record = None
    if call is not None and works:
        record, call.record = call.record, None
    task = Task(works, finish, record, call is not None and call.on_device)
    if sync_op:
        task.wait()
        return result
    return task


class _Inplace:
    """A contiguous buffer for an in-place collective on ``x``'s payload,
    written back by ``commit`` (a copy when the payload is not contiguous
    or requires grad)."""

    def __init__(self, x):
        self.target = _data(x)
        t = self.target
        self.buf = (t if t.is_contiguous() and not t.requires_grad
                    else t.detach().contiguous().clone())

    def commit(self):
        if self.buf is not self.target:
            with torch.no_grad():
                self.target.copy_(self.buf)


def _reduce_into(buf: torch.Tensor, op, g: Group):
    """(work, post) of an async all-reduce of ``buf`` in place; AVG is
    NCCL's own on floating data, else a sum divided after."""
    if op == ReduceOp.AVG and dist.get_backend(g.pg) == "nccl" and \
            buf.is_floating_point():
        return dist.all_reduce(buf, dist.ReduceOp.AVG, group=g.pg,
                               async_op=True), None
    work = dist.all_reduce(buf, _TORCH_OPS[
        ReduceOp.SUM if op == ReduceOp.AVG else op], group=g.pg,
        async_op=True)
    if op != ReduceOp.AVG:
        return work, None
    return work, lambda: buf.copy_(buf / g.nranks)


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """In place: every rank's tensor becomes the reduction over the
    group."""
    g = _group(group, "all_reduce")
    call = _Call("all_reduce", _data(tensor), g)
    with call:
        _op(op, "all_reduce")
        if call.bypassed():
            return call.done(tensor)
        io = _Inplace(tensor)
        if g.nranks == 1:
            return call.done(_finish(sync_op, (), io.commit, tensor, call))
        work, post = _reduce_into(io.buf, op, g)

        def finish():
            if post is not None:
                post()
            io.commit()
        return call.done(_finish(sync_op, [work], finish, tensor, call))


def _out_like(x: torch.Tensor, wrap: bool):
    return Tensor(x) if wrap else x


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Fill ``tensor_list`` with every rank's tensor, in group order."""
    g = _group(group, "all_gather")
    x = _data(tensor).detach().contiguous()
    call = _Call("all_gather", x, g)
    with call:
        outs = [torch.empty_like(x) for _ in range(g.nranks)]
        if tensor_list is None:
            tensor_list = []
        wrap = isinstance(tensor, Tensor)

        def finish():
            del tensor_list[:]
            tensor_list.extend(_out_like(o, wrap) for o in outs)
        if call.bypassed():        # this rank's tensor in every slot
            for o in outs:
                o.copy_(x)
            finish()
            return call.done(tensor_list)
        if g.nranks == 1:
            outs[0].copy_(x)
            return call.done(_finish(sync_op, (), finish, tensor_list, call))
        work = dist.all_gather(outs, x, group=g.pg, async_op=True)
        return call.done(_finish(sync_op, [work], finish, tensor_list, call))


def all_gather_object(object_list, obj, group=None):
    """Fill ``object_list`` with every rank's picklable ``obj``."""
    g = _group(group, "all_gather_object")
    call = _Call("all_gather_object", None, g)
    with call:
        out = [None] * g.nranks
        if g.nranks == 1:
            out[0] = obj
        else:
            dist.all_gather_object(out, obj, group=g.pg)
        del object_list[:]
        object_list.extend(out)
        return call.done(object_list)


def reduce_scatter(tensor, tensor_or_tensor_list, op=ReduceOp.SUM,
                   group=None, sync_op=True):
    """Rank i of the group gets chunk i (along dim 0) of the reduction of
    every rank's input (a tensor, or a list of one chunk a rank, which is
    concatenated). ``tensor`` receives it; with ``tensor=None`` it is
    returned."""
    g = _group(group, "reduce_scatter")
    _op(op, "reduce_scatter")
    src = tensor_or_tensor_list
    wrap = isinstance(src[0] if isinstance(src, (list, tuple)) else src,
                      Tensor)
    src = (torch.cat([_data(s) for s in src], 0)
           if isinstance(src, (list, tuple)) else _data(src))
    src = src.detach().contiguous()
    n = g.nranks
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 ({src.shape[0]}) must be "
                         f"a multiple of the group size ({n})")
    call = _Call("reduce_scatter", src, g)
    with call:
        out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        post = None
        if n == 1:
            out.copy_(src)
            works = []
        elif dist.get_backend(g.pg) == "nccl":
            top = (dist.ReduceOp.AVG if op == ReduceOp.AVG and
                   src.is_floating_point() else _TORCH_OPS.get(
                       op, dist.ReduceOp.SUM))
            works = [dist.reduce_scatter_tensor(out, src, op=top, group=g.pg,
                                                async_op=True)]
            if op == ReduceOp.AVG and top is not dist.ReduceOp.AVG:
                post = lambda: out.copy_(out / n)
        else:
            # gloo has no reduce-scatter: the reduction, then this rank's chunk
            full = src.clone()
            work, avg = _reduce_into(full, op, g)
            works = [work]

            def post():
                if avg is not None:
                    avg()
                out.copy_(full.chunk(n, 0)[g.rank])
        result = tensor

        def finish():
            if post is not None:
                post()
            if tensor is not None:
                io = _Inplace(tensor)
                io.buf.copy_(out)
                io.commit()
        if tensor is None:
            result = _out_like(out, wrap)
        return call.done(_finish(sync_op, works, finish, result, call))


def broadcast(tensor, src=0, group=None, sync_op=True):
    """In place: every rank's tensor becomes global rank ``src``'s."""
    g = _group(group, "broadcast")
    src = _peer(g, src, "broadcast", "src")
    call = _Call("broadcast", _data(tensor), g)
    with call:
        if call.bypassed():
            return call.done(tensor)
        io = _Inplace(tensor)
        if g.nranks == 1:
            return call.done(_finish(sync_op, (), io.commit, tensor, call))
        work = dist.broadcast(io.buf, src, group=g.pg, async_op=True)
        return call.done(_finish(sync_op, [work], io.commit, tensor, call))


def broadcast_object_list(object_list, src=0, group=None):
    """In place: ``object_list`` becomes global rank ``src``'s."""
    g = _group(group, "broadcast_object_list")
    src = _peer(g, src, "broadcast_object_list", "src")
    call = _Call("broadcast_object_list", None, g)
    with call:
        if g.nranks > 1:
            dist.broadcast_object_list(object_list, src, group=g.pg)
        return call.done(object_list)


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """In place on global rank ``dst``: the reduction over the group (the
    other ranks' tensors are left as they were)."""
    g = _group(group, "reduce")
    dst = _peer(g, dst, "reduce", "dst")
    _op(op, "reduce")
    call = _Call("reduce", _data(tensor), g)
    with call:
        io = _Inplace(tensor)
        if g.nranks == 1:
            return call.done(_finish(sync_op, (), io.commit, tensor, call))
        top = _TORCH_OPS[ReduceOp.SUM if op == ReduceOp.AVG else op]
        work = dist.reduce(io.buf, dst, top, group=g.pg, async_op=True)

        def finish():
            if dist.get_rank() == dst:
                if op == ReduceOp.AVG:
                    io.buf.copy_(io.buf / g.nranks)
                io.commit()
        return call.done(_finish(sync_op, [work], finish, tensor, call))


def scatter(tensor, tensor_or_tensor_list=None, src=0, group=None,
            sync_op=True):
    """Rank i of the group receives chunk i of global rank ``src``'s
    input (a list of one tensor a rank, or a tensor split along dim 0)
    into ``tensor``; the other ranks' inputs are not read."""
    g = _group(group, "scatter")
    src = _peer(g, src, "scatter", "src")
    n = g.nranks
    call = _Call("scatter", _data(tensor), g)
    with call:
        io = _Inplace(tensor)
        chunks = None
        if dist.get_rank() == src:
            source = tensor_or_tensor_list
            if source is None:
                source = tensor
            if isinstance(source, (list, tuple)):
                chunks = [_data(s).detach().contiguous() for s in source]
            else:
                chunks = [c.contiguous() for c in
                          _data(source).detach().chunk(n, 0)]
            if len(chunks) != n or any(c.shape != io.buf.shape
                                       for c in chunks):
                raise ValueError(f"scatter: the source must give {n} "
                                 f"chunks of shape {tuple(io.buf.shape)}")
        if n == 1:
            io.buf.copy_(chunks[0])
            return call.done(_finish(sync_op, (), io.commit, tensor, call))
        work = dist.scatter(io.buf, chunks, src=src, group=g.pg, async_op=True)
        return call.done(_finish(sync_op, [work], io.commit, tensor, call))


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Rank i's j-th input lands as rank j's i-th output (group order)."""
    g = _group(group, "alltoall")
    ins = [_data(x).detach().contiguous() for x in in_tensor_list]
    if len(ins) != g.nranks:
        raise ValueError(f"alltoall: {len(ins)} inputs for a group of "
                         f"{g.nranks}")
    call = _Call("all_to_all", ins[0], g)
    with call:
        outs = [torch.empty_like(x) for x in ins]
        wrap = isinstance(in_tensor_list[0], Tensor)
        if out_tensor_list is None:
            out_tensor_list = []

        def finish():
            del out_tensor_list[:]
            out_tensor_list.extend(_out_like(o, wrap) for o in outs)
        if g.nranks == 1:
            outs[0].copy_(ins[0])
            return call.done(_finish(sync_op, (), finish, out_tensor_list,
                                     call))
        work = dist.all_to_all(outs, ins, group=g.pg, async_op=True)
        return call.done(_finish(sync_op, [work], finish, out_tensor_list,
                                 call))


all_to_all = alltoall


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """``in_tensor`` split along dim 0 into one chunk a rank (equal, or
    ``in_split_sizes``); rank j receives every rank's j-th chunk,
    concatenated in group order (``out_split_sizes``). ``out_tensor``
    receives it; with ``out_tensor=None`` it is returned."""
    g = _group(group, "alltoall_single")
    x = _data(in_tensor).detach().contiguous()
    n = g.nranks
    for sizes, label in ((in_split_sizes, "in_split_sizes"),
                         (out_split_sizes, "out_split_sizes")):
        if sizes is not None and len(sizes) != n:
            raise ValueError(f"alltoall_single: {label}={list(sizes)} must "
                             f"have one entry a rank ({n})")
    if in_split_sizes is not None and sum(in_split_sizes) != x.shape[0]:
        raise ValueError(f"alltoall_single: in_split_sizes sum to "
                         f"{sum(in_split_sizes)}, dim 0 is {x.shape[0]}")
    if in_split_sizes is None and x.shape[0] % n:
        raise ValueError(f"alltoall_single: dim 0 ({x.shape[0]}) must be a "
                         f"multiple of the group size ({n})")
    rows = (sum(out_split_sizes) if out_split_sizes is not None
            else x.shape[0])
    call = _Call("all_to_all_single", x, g)
    with call:
        out = torch.empty((rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        wrap = isinstance(in_tensor, Tensor)

        def finish():
            if out_tensor is not None:
                io = _Inplace(out_tensor)
                io.buf.copy_(out)
                io.commit()
        result = out_tensor if out_tensor is not None else _out_like(out, wrap)
        if n == 1:
            out.copy_(x)
            return call.done(_finish(sync_op, (), finish, result, call))
        work = dist.all_to_all_single(
            out, x, output_split_sizes=None if out_split_sizes is None
            else [int(s) for s in out_split_sizes],
            input_split_sizes=None if in_split_sizes is None
            else [int(s) for s in in_split_sizes], group=g.pg, async_op=True)
        return call.done(_finish(sync_op, [work], finish, result, call))


#: what a barrier's flight record describes (the JAX package's 0-d fp32
#: token)
_BARRIER_TOKEN = torch.zeros(())


def barrier(group=None):
    """Return when every rank of the group has entered it (a one-element
    all-reduce on this rank's device)."""
    g = _group(group, "barrier")
    call = _Call("barrier", _BARRIER_TOKEN, g)
    with call:
        if g.nranks > 1 and not call.bypassed():
            dev = (torch.device("cuda", torch.cuda.current_device())
                   if dist.get_backend(g.pg) == "nccl"
                   else torch.device("cpu"))
            token = torch.zeros(1, device=dev)
            dist.all_reduce(token, group=g.pg)
            token.cpu()         # the host waits: the record closes after
        call.done()


# --------------------------------------------------------------------- p2p
def send(tensor, dst=0, group=None, sync_op=True):
    g = _group(group, "send")
    dst = _peer(g, dst, "send", "dst")
    x = _data(tensor).detach().contiguous()
    call = _Call("send", x, g)
    with call:
        work = dist.isend(x, dst, group=g.pg)
        return call.done(_finish(sync_op, [work], None, None, call))


def recv(tensor, src=0, group=None, sync_op=True):
    g = _group(group, "recv")
    src = _peer(g, src, "recv", "src")
    call = _Call("recv", _data(tensor), g)
    with call:
        io = _Inplace(tensor)
        work = dist.irecv(io.buf, src, group=g.pg)
        return call.done(_finish(sync_op, [work], io.commit, tensor, call))


def isend(tensor, dst, group=None):
    return send(tensor, dst, group=group, sync_op=False)


def irecv(tensor, src=None, group=None):
    return recv(tensor, src, group=group, sync_op=False)


class P2POp:
    """One half of a point-to-point exchange (reference
    communication/batch_isend_irecv.py P2POp): ``op`` is ``isend`` or
    ``irecv``, ``peer`` a global rank."""

    def __init__(self, op, tensor, peer, group=None):
        if op not in (isend, irecv, send, recv):
            raise ValueError("P2POp: op must be isend or irecv")
        self.op = op
        self.tensor = tensor
        self.peer = int(peer)
        self.group = group


def batch_isend_irecv(p2p_op_list) -> List[Task]:
    """Issue every send and receive of the list together; one ``Task`` an
    op (received tensors are ready after its ``wait()``)."""
    if not p2p_op_list:
        return []
    groups = []
    for p in p2p_op_list:
        g = _group(p.group, "batch_isend_irecv")
        _peer(g, p.peer, "batch_isend_irecv", "peer")
        groups.append(g)
    call = _Call("batch_isend_irecv", _data(p2p_op_list[0].tensor),
                 groups[0])
    with call:
        ops, commits = [], []
        for p, g in zip(p2p_op_list, groups):
            if p.op in (isend, send):
                buf = _data(p.tensor).detach().contiguous()
                ops.append(dist.P2POp(dist.isend, buf, p.peer, group=g.pg))
                commits.append(None)
            else:
                io = _Inplace(p.tensor)
                ops.append(dist.P2POp(dist.irecv, io.buf, p.peer,
                                      group=g.pg))
                commits.append(io.commit)
        works = dist.batch_isend_irecv(ops)
        tasks = [Task([w], c) for w, c in zip(works, commits)]
        call.done()
    return tasks


def shift_along_axis(tensor, axis_name, shift, mesh=None):
    """The tensor of the rank ``shift`` places before this one along the
    mesh axis ``axis_name`` (coordinate i's tensor moves to coordinate
    (i + shift) mod n), a new tensor."""
    mesh = mesh or mesh_mod.get_mesh()
    x = _data(tensor).detach().contiguous()
    n = mesh.axis_size(axis_name)
    if n == 1 or shift % n == 0:
        out = x.clone()
    else:
        g = mesh.group((axis_name,))
        i = g.rank
        out = torch.empty_like(x)
        tasks = batch_isend_irecv([
            P2POp(isend, x, g.ranks[(i + shift) % n], g),
            P2POp(irecv, out, g.ranks[(i - shift) % n], g)])
        for t in tasks:
            t.wait()
    return Tensor(out) if isinstance(tensor, Tensor) else out
