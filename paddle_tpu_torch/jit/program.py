"""Programs recorded from the op dispatcher: the Paddle-API half of
``to_static`` (what the JAX package gets from tracing its dispatcher
under ``jax.jit``).

``Recorder`` taps ``core.dispatch`` (``register_recorder_hook``) while a
Paddle-API callable runs once, eagerly, on the first call of a
signature. Each op becomes a step: its name and attrs, the replayable
lowering the dispatcher ran, the amp state it ran under, and value ids
for its input and output payloads (``id`` of the ``torch.Tensor``; the
recorder holds every payload it saw until the program is built, so an
id is never reused). ``Program`` replays the steps through
``dispatch.call`` on the next calls of that signature.

What a step reads is one of four kinds:

* a value a recorded step made;
* an argument of the call (bound anew on every replay);
* a constant the call made outside the dispatcher (``ops.arange``,
  ``zeros``, ``to_tensor``): the payload it was made with, as a JAX
  trace bakes it;
* anything else, a tensor that existed before the call (a parameter, a
  buffer, a tensor the function closes over): the replay passes the
  ``Tensor`` wrapper the recording met, so the dispatcher reads its
  payload at that moment. A parameter an optimizer updated, a buffer
  whose payload ``set_value`` swapped, a weight reached by closure: each
  is read live.

A value that would not replay is refused as a graph break
(``core.tensor.GraphBreak``, which ends the call; ``to_static`` then
raises, or runs the signature under SOT): host reads, a payload change
of a tensor that existed before the call (an argument, a parameter, a
buffer), random creation ops, autograd and optimizer calls, and a tensor
outside the dispatcher's record that shares storage with a recorded
value (a view or ``detach`` made on the payload directly). A block under
``models._remat.remat_block`` is a region: a program of its own, run
under ``fleet.recompute``, which the fusion pass rewrites apart (no
fused chain crosses its edge).

Dropout's lowering closes over the generator it drew from, which stays
the same object across ``paddle.seed``, so a replay draws afresh, in
eager's order.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..amp.state import amp_state, amp_state_as
from ..core import dispatch
from ..core.tensor import GraphBreak, Tensor, capture_scope
from ..nn.parameter import Parameter

__all__ = ["Recorder", "Program", "Region", "flatten", "unflatten", "record"]


# --------------------------------------------------------------- pytrees
def flatten(obj) -> Tuple[object, list]:
    """(structure, Tensor leaves) of nested tuples, lists and dicts; other
    leaves are kept in the structure."""
    leaves: list = []
    return _flatten(obj, leaves), leaves


def _flatten(o, leaves: list):
    # a module function, not a closure: a recursive closure is a cycle
    # that would keep the leaves (and their graphs) to the next collection
    if isinstance(o, Tensor):
        leaves.append(o)
        return ("T",)
    if isinstance(o, (tuple, list)):
        return (type(o), tuple(_flatten(x, leaves) for x in o))
    if isinstance(o, dict):
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in o.items()))
    return ("C", o)


def unflatten(structure, leaves: Sequence):
    return _unflatten(structure, iter(leaves))


def _unflatten(s, it):
    tag = s[0]
    if tag == "T":
        return next(it)
    if tag == "C":
        return s[1]
    if tag is dict:
        return {k: _unflatten(v, it) for k, v in s[1]}
    return tag(_unflatten(x, it) for x in s[1])


# ----------------------------------------------------------------- steps
class _Step:
    """One recorded op, as the fusion pass reads it (``name``, ``in_ids``,
    ``out_ids``, ``attrs``, ``in_shapes``, ``out_shapes``, ``amp``,
    ``loc``) and as the replay runs it (``fn``)."""

    __slots__ = ("name", "fn", "in_ids", "out_ids", "attrs", "in_shapes",
                 "out_shapes", "amp", "loc", "pattern")

    def __init__(self, name, fn, in_ids, out_ids, attrs, in_shapes,
                 out_shapes, amp, loc):
        self.name, self.fn = name, fn
        self.in_ids, self.out_ids = tuple(in_ids), tuple(out_ids)
        self.attrs = attrs
        self.in_shapes, self.out_shapes = tuple(in_shapes), tuple(out_shapes)
        self.amp, self.loc = amp, loc
        self.pattern = ""


def _run_step(st, ins: list) -> list:
    """Replay one step (a recorded op, a fused op or a region) on Tensor
    inputs under its amp state, and under its grad mode where it has one
    (an SOT segment's steps); returns its output Tensors."""
    grad = getattr(st, "grad", None)
    if grad is not None and grad != torch.is_grad_enabled():
        with torch.set_grad_enabled(grad):
            return _run_step(st, ins)
    if st.amp != amp_state():
        with amp_state_as(st.amp):
            return _run_step(st, ins)
    if st.pattern or isinstance(st.fn, Region):
        outs = st.fn(*ins)          # a Paddle-API fused op, a region
    else:
        outs = dispatch.call(st.name, st.fn, ins)
    return list(outs) if isinstance(outs, (tuple, list)) else [outs]


class Program:
    """A recorded op stream, replayable on new arguments."""

    def __init__(self, steps: list, inputs: Dict[int, int],
                 externals: Dict[int, Tensor], structure, out_ids: list):
        self.steps = steps
        #: value id -> index of the argument Tensor that binds it
        self.inputs = inputs
        #: value id -> the Tensor read live at replay
        self.externals = externals
        self.structure = structure
        self.out_ids = out_ids
        self._free: List[list] = []
        self.plan()

    def regions(self) -> List["Region"]:
        return [st.fn for st in self.steps if isinstance(st.fn, Region)]

    def plan(self) -> None:
        """Recompute when each value is last read, so the replay drops it
        there, as eager code lets go of a temporary."""
        last: Dict[int, int] = {}
        for i, st in enumerate(self.steps):
            for v in st.in_ids:
                last[v] = i
            for v in st.out_ids:
                last.setdefault(v, i)
        keep = set(self.out_ids)
        self._free = [[] for _ in self.steps]
        for v, i in last.items():
            if v not in keep and v not in self.externals \
                    and v not in self.inputs:
                self._free[i].append(v)

    def __call__(self, *args: Tensor, steps: Optional[list] = None):
        """Replay on ``args``; ``steps``, where given, run in place of the
        recorded steps, one for one, with the same value ids (an SOT
        segment's plan runs each call's own lowerings)."""
        env: Dict[int, Tensor] = {v: args[k] for v, k in self.inputs.items()}
        ext = self.externals
        for st, free in zip(self.steps if steps is None else steps,
                            self._free):
            ins = [env[v] if v in env else ext[v] for v in st.in_ids]
            env.update(zip(st.out_ids, _run_step(st, ins)))
            for v in free:
                env.pop(v, None)
        outs = [env[v] if v in env else ext[v] for v in self.out_ids]
        return unflatten(self.structure, outs)


class Region:
    """A ``remat_block`` block's program: replayed under
    ``fleet.recompute`` while grad is enabled, plainly otherwise."""

    def __init__(self, program: Program):
        self.program = program

    def __call__(self, *tensors: Tensor):
        if not torch.is_grad_enabled():
            return self.program(*tensors)
        from ..distributed.fleet.recompute import recompute
        return recompute(self.program, *tensors)


# -------------------------------------------------------------- recorder
class Recorder:
    """Records the ops dispatched on this thread while it is active
    (``record``); ``strict`` makes a graph break raise, else the
    recording ends and ``broken`` holds the reason."""

    def __init__(self, args: Sequence[Tensor], strict: bool,
                 parent: Optional["Recorder"] = None):
        # no reference to itself: the payloads it holds go with its last
        # reference, not at the next cyclic collection
        self._root = parent.root if parent is not None else None
        self.strict = strict
        self.steps: List[_Step] = []
        self.inputs: Dict[int, int] = {}
        self.externals: Dict[int, Tensor] = {}
        self._produced: set = set()
        self._child: Optional[Recorder] = None
        if parent is None:
            #: why the recording ended early (None: it did not)
            self.broken: Optional[str] = None
            self._keep: list = []           # every payload seen: ids stay
            self._storages: set = set()     # storages of recorded values
            self._made: set = set()         # wrappers the call made
            #: a recording that is not strict: id -> (payload, copy) of
            #: each tensor from before the call that an op read,
            #: parameters and arguments aside
            self._before: dict = {}
        for k, t in enumerate(args):
            self.inputs.setdefault(self._note(t._data), k)

    @property
    def root(self) -> "Recorder":
        return self._root or self

    def release(self) -> None:
        """Drop what only the recording needed (every payload it saw)."""
        self._keep, self._storages, self._made = [], set(), set()
        self._before = {}

    def before(self, tensor_inputs: Sequence[Tensor]) -> None:
        """Before an op runs in a recording that is not strict: keep a
        copy of each tensor from before the call that it reads (a buffer,
        a tensor the function closes over; not a parameter or an
        argument), the first time an op reads it, so that a break can put
        back what a lowering changed in place (``restore``)."""
        root = self.root
        if root.strict or root.broken is not None:
            return
        kept = root._before
        for t in tensor_inputs:
            d = t._data
            if id(d) in kept or id(t) in root._made \
                    or id(d) in root.inputs or isinstance(t, Parameter):
                continue
            kept[id(d)] = (d, d.detach().clone())

    def restore(self) -> None:
        """After a break: put back each tensor ``before`` kept as the call
        found it, whatever an op changed in place (a kernel that updates
        batch norm's running statistics leaves their version counter as
        it was, so every copy goes back)."""
        with torch.no_grad():
            for d, copy in self._before.values():
                d.copy_(copy)
        self._before = {}

    # ------------------------------------------------------------ values
    def _note(self, payload: torch.Tensor) -> int:
        root = self.root
        root._keep.append(payload)
        if payload.numel():
            root._storages.add(payload.untyped_storage().data_ptr())
        return id(payload)

    def _value(self, t: Tensor) -> int:
        d = t._data
        v = id(d)
        if v in self._produced or v in self.inputs or v in self.externals:
            return v
        root = self.root
        if d.numel() and d.untyped_storage().data_ptr() in root._storages:
            self.graph_break(
                "a tensor made outside the dispatcher from a recorded value")
        root._keep.append(d)
        # a constant of the call keeps the payload it was made with; a
        # tensor from before the call is read live
        self.externals[v] = Tensor(d) if id(t) in root._made else t
        return v

    def note_new(self, t: Tensor) -> None:
        root = self.root
        root._made.add(id(t))
        root._keep.append(t)

    # ------------------------------------------------------------- taps
    def hook(self, op_name, fn, tensor_inputs, out_tensors, attrs):
        if self._child is not None:
            return self._child.hook(op_name, fn, tensor_inputs, out_tensors,
                                    attrs)
        if self.root.broken is not None:
            return
        in_ids = [self._value(t) for t in tensor_inputs]
        out_ids = []
        for t in out_tensors:
            v = self._note(t._data)
            self._produced.add(v)
            out_ids.append(v)
        self.steps.append(_Step(
            op_name, fn, in_ids, out_ids, dict(attrs or {}),
            [tuple(t.shape) for t in tensor_inputs],
            [tuple(t.shape) for t in out_tensors], amp_state(),
            str(len(self.steps))))

    def graph_break(self, reason: str) -> None:
        """End the recording: raise ``GraphBreak``; a recording that is
        not strict notes ``reason`` in ``broken`` first, and ``record``
        takes the raise as its end."""
        root = self.root
        if not root.strict and root.broken is None:
            root.broken = reason
        raise GraphBreak(reason)

    def note_swap(self, t: Tensor, payload: torch.Tensor) -> None:
        """A payload change (in-place ops, ``setitem``): allowed on a
        tensor the call made, a graph break on one from before the call
        (an argument, a parameter, a buffer), whose change a replay would
        not carry out."""
        if self.root.broken is None and id(t) not in self.root._made:
            self.graph_break("an in-place change of an argument, a "
                             "parameter or a buffer")

    def detach(self, t: Tensor) -> Tensor:
        return dispatch.call("detach", torch.Tensor.detach, [t])

    def region(self, blk, args: Sequence):
        """Run ``blk(*args)`` (``remat_block``) recording its ops as a
        region; returns its output."""
        if self._child is not None:
            return self._child.region(blk, args)
        tensors = [a for a in args if isinstance(a, Tensor)]
        child = Recorder(tensors, self.root.strict, parent=self)
        self._child = child
        try:
            if torch.is_grad_enabled():
                from ..distributed.fleet.recompute import recompute
                out = recompute(blk, *args)
            else:
                out = blk(*args)
        finally:
            self._child = None
        if self.root.broken is not None:
            return out
        structure, leaves = flatten(out)
        program = child.program(structure, leaves)
        in_ids = [self._value(t) for t in tensors]
        out_ids = []
        for t in leaves:
            v = self._note(t._data)
            self._produced.add(v)
            out_ids.append(v)
        self.steps.append(_Step(
            "remat_region", Region(program), in_ids, out_ids, {},
            [tuple(t.shape) for t in tensors],
            [tuple(t.shape) for t in leaves], amp_state(),
            str(len(self.steps))))
        return out

    # ---------------------------------------------------------- program
    def program(self, structure, leaves: Sequence[Tensor]) -> Program:
        out_ids = [self._value(t) for t in leaves]
        return Program(self.steps, self.inputs, self.externals, structure,
                       out_ids)


def record(fn, args: tuple, kwargs: dict, tensors: Sequence[Tensor],
           strict: bool):
    """Run ``fn(*args, **kwargs)`` once, eagerly, recording its ops; the
    Tensor arguments ``tensors`` bind the program's inputs. Returns
    (output, program, recorder). A graph break raises ``GraphBreak``
    where ``strict``; otherwise it ends the call there: output and
    program are None, the recorder's ``broken`` says why, and the
    tensors from before the call that an op changed in place are put
    back (``Recorder.restore``)."""
    rec = Recorder(tensors, strict)
    dispatch.register_recorder_hook(rec.hook)
    try:
        with capture_scope(rec):
            out = fn(*args, **kwargs)
    except GraphBreak:
        if rec.broken is None:
            raise
        out = None
    finally:
        dispatch.unregister_recorder_hook(rec.hook)
    if rec.broken is not None:
        rec.restore()
        rec.release()
        return out, None, rec
    structure, leaves = flatten(out)
    with capture_scope(rec):
        program = rec.program(structure, leaves)
    rec.release()
    return out, (None if rec.broken is not None else program), rec
