"""Static-graph ``Program`` / ``Executor`` (counterpart of
``paddle_tpu/static/program.py``).

A ``Program`` records the ops dispatched inside its ``program_guard``
block; ``Executor.run`` replays them over feeds. The block runs eagerly,
on the placeholders that ``data`` makes (zeros at the example shape, 1
for a -1 or None dim), while the dispatcher's recorder hook
(``core.dispatch.register_recorder_hook``) turns each op into a step of
``jit/program.py``. A run replays the steps through that module's
``Program`` (``_run_step``, and ``plan``'s frees, which drop a value
after its last read).

What a step reads is one of three kinds:

* a value a recorded step made;
* a feed slot: a ``data`` placeholder, bound anew on every run;
* a captured tensor: one no step made and no feed binds (a parameter, a
  buffer, a constant made in the block), read live through its
  ``Tensor``, so a weight an optimizer, ``set_value`` or
  ``set_program_state`` changed between runs is the one the next run
  reads.

Values are keyed on their torch payloads, as ``to_static``'s recorder
keys them, and the program holds every payload it saw, so an id is never
reused. A fetch is the value its Tensor holds when ``run`` is called (its
payload, else the value the Tensor was recorded with): a tensor an
in-place op changed in the block (the op swaps its payload) is fetched
changed, as eager code reads it.

While the guard is open the program is also this thread's capture
(``core.tensor.capture_scope``), so the block records what a ``to_static``
recording records: a control-flow construct (``static.nn.cond``,
``while_loop``, ...) is one op whose replay takes the branch and the trip
count of the run's data, and ``detach`` is an op. Reads on the host in
the block are allowed: the block runs eagerly and reads the example
values, as the JAX package's block does. A block under
``models._remat.remat_block`` is recorded inline.

``Executor.run`` keeps one replay plan per signature, as the JAX package
keeps one compiled program per signature (``Program._plans``): the
feeds' names, shapes and dtypes, the fetched values, the captured set
(extending the program makes a new plan) and, with
``FLAGS_enable_fusion``, the fusion pass's fingerprint. With the flag
on, the pass (``compile.fusion.fuse_program_ops``, the fetched values as
its external set) rewrites the plan onto the fused ops, and
``fusion_stats`` holds its stats. Steps no fetch needs are then left out
of the plan, as XLA drops the JAX program's dead values. A run replays
under ``no_grad`` and returns numpy arrays (bf16 as float32), or
Tensors with ``return_numpy=False``.

A run takes place on the ``Executor``'s place, else on the Paddle API's
device (``set_device``): the card unless the caller asked for the CPU.
Without CUDA, a card run raises; a program whose captured tensors lie on
another device than the run's raises too. Nothing moves to the CPU.

The JAX package's ``FLAGS_verify_programs`` check, its verifier and the
cross-rank program dump (``crossrank.maybe_dump``) are not here: they
wait for ``distributed.spmd`` and ``distributed.planner`` (ROADMAP).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..amp.state import amp_state
from ..core import dispatch
from ..core.dtype import convert_dtype, dtype_name
from ..core.place import current_device
from ..core.tensor import Tensor, capture_scope
from ..jit.program import Program as _Replay
from ..jit.program import _Step

__all__ = ["Program", "program_guard", "data", "Executor",
           "CompiledProgram", "default_main_program",
           "default_startup_program"]

_state = threading.local()


class _Block:
    """The program's one block: its steps in recording order."""

    def __init__(self):
        self.ops: List[_Step] = []

    def __repr__(self):
        return "\n".join(
            f"  {', '.join(f'v{o}' for o in op.out_ids)} = {op.name}("
            f"{', '.join(f'v{i}' for i in op.in_ids)})" for op in self.ops)


class Program:
    """A recorded op list (reference ``static.Program``)."""

    def __init__(self):
        self._block = _Block()
        #: data() name -> value id of its placeholder
        self.feed_vars: Dict[str, int] = {}
        self._feeds: set = set()
        self._feed_shapes: Dict[str, tuple] = {}
        self._feed_dtypes: Dict[str, str] = {}
        #: value id -> the Tensor read live at a run
        self._captured: Dict[int, Tensor] = {}
        self._produced: set = set()
        #: id of a Tensor the block met -> the value it held there
        self._held: Dict[int, int] = {}
        self._keep: list = []           # every payload and Tensor seen
        self._plans: Dict[tuple, tuple] = {}
        #: the fusion pass's stats of the last fused run (None: the pass
        #: never ran on this program)
        self.fusion_stats: Optional[dict] = None

    # -------------------------------------------------------- recording
    def _known(self, v: int) -> bool:
        return v in self._produced or v in self._captured or v in self._feeds

    def _note(self, t: Tensor) -> int:
        d = t._data
        self._keep.append(d)
        self._keep.append(t)
        self._held[id(t)] = id(d)
        return id(d)

    def _value(self, t: Tensor) -> int:
        v = id(t._data)
        if not self._known(v):
            self._captured[v] = t
            self._note(t)
        return v

    def hook(self, op_name, fn, tensor_inputs, out_tensors, attrs):
        """The dispatcher's recorder hook: one op, one step."""
        in_ids = [self._value(t) for t in tensor_inputs]
        out_ids = []
        for t in out_tensors:
            v = self._note(t)
            self._produced.add(v)
            out_ids.append(v)
        self._block.ops.append(_Step(
            op_name, fn, in_ids, out_ids, dict(attrs or {}),
            [tuple(t.shape) for t in tensor_inputs],
            [tuple(t.shape) for t in out_tensors], amp_state(),
            str(len(self._block.ops))))

    # the capture protocol of core.tensor (what jit/program.Recorder
    # answers while to_static records)
    @property
    def root(self) -> "Program":
        return self

    broken = None

    def graph_break(self, reason: str) -> None:
        """A host read or a state change in the block: allowed, the block
        runs eagerly."""

    def note_new(self, t: Tensor) -> None:
        pass

    def before(self, tensor_inputs) -> None:
        """An op is about to run: the block keeps what it changes."""

    def note_swap(self, t: Tensor, payload: torch.Tensor) -> None:
        """A captured Tensor that takes over a recorded op's output (an
        in-place op): the steps that read it before read the payload it
        had, not the Tensor."""
        v = self._held.get(id(t))
        if v is not None and self._captured.get(v) is t \
                and id(payload) in self._produced:
            self._captured[v] = Tensor(t._data)
            self._held[id(t)] = id(payload)

    def detach(self, t: Tensor) -> Tensor:
        return dispatch.call("detach", torch.Tensor.detach, [t])

    def region(self, blk, args):
        return blk(*args)

    # ------------------------------------------------------ introspection
    def global_block(self):
        return self._block

    def list_vars(self) -> list:
        seen = {}
        for op in self._block.ops:
            for v in op.in_ids + op.out_ids:
                seen.setdefault(v, None)
        return list(seen)

    def to_string(self, throw_on_error=False, with_details=False) -> str:
        feeds = ", ".join(f"{n}: v{i}{list(self._feed_shapes[n])}"
                          for n, i in self.feed_vars.items())
        return (f"Program(feeds=[{feeds}], "
                f"params={len(self._captured)})\n{self._block!r}")

    __repr__ = to_string

    # ---------------------------------------------------------- running
    def _fetch_id(self, t) -> int:
        if not isinstance(t, Tensor):
            raise TypeError(f"fetch_list holds Tensors of the program, "
                            f"got {type(t).__name__}")
        v = id(t._data)
        if self._known(v):
            return v
        v = self._held.get(id(t))
        if v is None or not self._known(v):
            raise ValueError(f"fetch {t.name!r} is not a value of this "
                             f"program")
        return v

    def _feed(self, name: str, value, device: torch.device) -> Tensor:
        if isinstance(value, Tensor):
            a = value._data
        elif isinstance(value, torch.Tensor):
            a = value
        else:
            a = torch.as_tensor(np.asarray(value))
        # a declared dtype is honored: an int feed of a float32 slot is cast
        return Tensor(a.detach().to(device=device, dtype=convert_dtype(
            self._feed_dtypes[name])))

    def _check_device(self, device: torch.device) -> None:
        for t in self._captured.values():
            d = t._data.device
            if d != device:
                raise ValueError(
                    f"the program reads {t.name!r} on {d}, the run is on "
                    f"{device}: build and run a program on one device")

    def _plan(self, feed_ids, fetch_ids, fuse: bool):
        """The replay of the steps the fetches need (fused onto the fused
        ops first, with the flag on), its arguments the values
        ``feed_ids``; and the pass's stats."""
        from ..compile import fusion
        steps, stats = list(self._block.ops), None
        if fuse:
            steps, stats = fusion.fuse_program_ops(steps, fetch_ids)
        needed, live = set(fetch_ids), []
        for st in reversed(steps):
            if needed.intersection(st.out_ids):
                live.append(st)
                needed.update(st.in_ids)
        replay = _Replay(live[::-1],
                         {v: k for k, v in enumerate(feed_ids)},
                         dict(self._captured),
                         (list, tuple(("T",) for _ in fetch_ids)),
                         list(fetch_ids))
        return replay, stats

    def run(self, feed: dict, fetch_list, device: torch.device,
            return_numpy: bool = True):
        """Replay the program over ``feed`` (name -> array) on ``device``;
        the values of ``fetch_list``."""
        from ..compile import fusion
        names = sorted(self.feed_vars)
        missing = [n for n in names if n not in feed]
        if missing:
            raise KeyError(f"missing feeds: {missing}")
        self._check_device(device)
        tensors = [self._feed(n, feed[n], device) for n in names]
        fetch_ids = [self._fetch_id(t) for t in fetch_list]
        fuse = fusion.enabled()
        sig = (tuple((n, tuple(t._data.shape), t._data.dtype)
                     for n, t in zip(names, tensors)), tuple(fetch_ids),
               tuple(self._captured))
        if fuse:
            sig += (fusion.fingerprint(),)
        if sig not in self._plans:
            self._plans[sig] = self._plan(
                [self.feed_vars[n] for n in names], fetch_ids, fuse)
        replay, stats = self._plans[sig]
        if fuse:
            self.fusion_stats = stats
        with torch.no_grad():
            outs = replay(*tensors)
        if return_numpy:
            return [o.numpy() for o in outs]
        return outs

    def _replay_fn(self, feed_vars, fetch_vars):
        """The unfused feed -> fetch replay as a function of the feed
        Tensors (``save_inference_model``'s program)."""
        feed_ids = [self._held.get(id(t)) for t in feed_vars]
        for t, v in zip(feed_vars, feed_ids):
            if v not in self._feeds:
                raise ValueError(f"{t.name!r} is not a data() of this "
                                 f"program")
        replay, _ = self._plan(
            feed_ids, [self._fetch_id(t) for t in fetch_vars], False)
        return replay


def _current() -> Optional[Program]:
    return getattr(_state, "program", None)


_default_main = Program()
_default_startup = Program()


def default_main_program() -> Program:
    return _current() or _default_main


def default_startup_program() -> Program:
    return _default_startup


class program_guard:
    """Record the block's dispatched ops into ``main`` (reference
    ``static.program_guard``); a nested guard records into the inner
    program only."""

    def __init__(self, main: Program, startup: Optional[Program] = None):
        self.main = main
        self.startup = startup

    def __enter__(self):
        self._prev = _current()
        if self._prev is not None:
            dispatch.unregister_recorder_hook(self._prev.hook)
        _state.program = self.main
        dispatch.register_recorder_hook(self.main.hook)
        self._capture = capture_scope(self.main)
        self._capture.__enter__()
        return self

    def __exit__(self, *exc):
        self._capture.__exit__(*exc)
        dispatch.unregister_recorder_hook(self.main.hook)
        if self._prev is not None:
            dispatch.register_recorder_hook(self._prev.hook)
        _state.program = self._prev
        return False


def data(name: str, shape, dtype="float32", lod_level=0) -> Tensor:
    """Declare a program input (reference ``static.data``): a placeholder
    Tensor, zeros at the example shape on the current device, whose
    payload marks the feed slot; a -1 or None dim replays at whatever
    size the feed has, where no op baked the example size in."""
    prog = _current()
    if prog is None:
        raise RuntimeError("static.data must be called under program_guard")
    example = tuple(1 if (s is None or s == -1) else int(s) for s in shape)
    t = Tensor(torch.zeros(example, dtype=convert_dtype(dtype),
                           device=current_device()), name=name)
    prog.feed_vars[name] = prog._note(t)
    prog._feeds.add(prog.feed_vars[name])
    prog._feed_shapes[name] = tuple(
        -1 if (s is None or s == -1) else int(s) for s in shape)
    prog._feed_dtypes[name] = dtype_name(convert_dtype(dtype))
    return t


class Executor:
    """Replay a Program over feeds (reference ``static.Executor``). The
    run takes place on ``place`` (a ``CPUPlace``/``CUDAPlace``), else on
    the Paddle API's device."""

    def __init__(self, place=None):
        self.place = place

    def run(self, program=None, feed=None, fetch_list=None,
            return_numpy: bool = True):
        if isinstance(program, CompiledProgram):
            program = program.program
        program = program or default_main_program()
        device = self.place.torch_device() if self.place is not None \
            else current_device()
        return program.run(feed or {}, fetch_list or [], device,
                           return_numpy)


class CompiledProgram:
    """The JAX package's parity name (reference ``CompiledProgram``): a
    Program keeps its replay plans per signature already."""

    def __init__(self, program: Program, build_strategy=None):
        self.program = program
