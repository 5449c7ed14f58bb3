"""``to_static`` and ``save``/``load`` (counterpart of
``paddle_tpu/jit/api.py``).

The JAX package traces a function into one XLA program per input
signature. The port captures in one of two ways, chosen by the callable
and its arguments' types:

* a ``torch.nn.Module``, or a function called on ``torch.Tensor``s: the
  ``torch.fx`` path. One ``GraphModule`` per signature, run eagerly
  (``compile/fusion/fx.py``). The module's parameters stay its own: the
  graph reads them through the module. The whole callable is traced;
  where ``torch.fx`` cannot trace it, the call raises.
* a Paddle-API ``Layer`` (``to_static(layer)`` wraps ``layer.forward``
  and returns the layer), or a function called on Paddle ``Tensor``s:
  the op-stream path (``jit/program.py``). The first call of a signature
  runs eagerly while the dispatcher's recorder takes its ops; the next
  calls replay that program through ``dispatch.call``, reading every
  parameter and buffer live. A graph break (a host read, a change of a
  parameter's payload, ...) raises with ``full_graph=True``. With
  ``full_graph=False`` it ends the recording there, warns, sets
  ``graph_break_reason``, counts ``paddle_tpu_graph_break_total``, puts
  the generators and the tensors a lowering changed in place (batch
  norm's running statistics) back where the call found them and runs
  the call again under SOT partial-frame capture (``jit/sot``), as the
  signature's calls run from then on: the ops between host reads run as
  cached segments (fused with ``FLAGS_enable_fusion``), each read runs
  eagerly, and a stable grad-free frame skips Python (``sot_stats``:
  segments, plans made, whether the call bypassed;
  ``paddle_tpu_sot_frame_total{mode}`` counts replays and bypasses). A
  replay's outputs carry torch autograd, so they are differentiable; the
  JAX package's are ``stop_gradient`` (ROADMAP Queue 3).

A call whose arguments mix the two kinds of tensor raises.

The signature is the tensors' shapes, dtypes and devices, the values of
the other arguments, the modules' ``training`` flags, the amp state
(``amp.auto_cast``'s level, dtype and custom lists; each recorded op
runs under the state it was recorded under) and, with
``FLAGS_enable_fusion``, the fusion pass's fingerprint, so fused and
unfused programs never share an entry; on the op-stream path also the
collected parameters' and buffers' shapes, dtypes and devices. With the
flag on, the graph-fusion pass (``compile/fusion``) rewrites the program
onto the fused ops, and ``fusion_stats`` holds the pass's stats for the
last call's signature (``None`` with the flag off, as in the JAX
package).

Compile telemetry, as the JAX package's: ``paddle_tpu_to_static_
compile_total{kind}`` (initial, retrace), ``_compile_seconds{kind}``,
``_retrace_total{reason}`` (new_input_shapes, new_static_args,
new_structure), the ``to_static_compile:<name>`` span, the goodput
ledger's ``compile`` bucket and the sentinel's compile feed. On the
op-stream path a signature's compile is its recording call.

``save`` exports a Paddle-API program with ``torch.export`` (the JAX
package exports StableHLO with ``jax.export``): parameters and buffers
are one dict input, as in the JAX ``pure``, and a -1 in an
``InputSpec`` is a dynamic dim. ``load`` gives a ``TranslatedLayer``
that runs the program on one device without the model class. The
persistent compile cache and ``precompile`` are a later slice.
"""
from __future__ import annotations

import functools
import inspect
import os
import pickle
import time
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..amp.state import amp_state
from ..compile import fusion
from ..compile.fusion.fx import trace_program
from ..core import flags, generator
from ..core.tensor import Tensor, active_capture, active_sot, as_tensor
from ..observability import goodput as _goodput
from ..observability import metrics as _metrics
from ..observability import perf as _perf
from ..observability import sentinel as _sentinel
from ..observability import trace as _trace
from .program import flatten, unflatten

__all__ = ["StaticFunction", "to_static", "not_to_static", "ignore_module",
           "in_capture_mode", "save", "load", "TranslatedLayer",
           "ArtifactVersionError"]

_m_compile = _metrics.counter(
    "paddle_tpu_to_static_compile_total",
    "to_static program builds: initial = first signature of a "
    "StaticFunction, retrace = additional signature.",
    labelnames=("kind",))
_m_compile_time = _metrics.histogram(
    "paddle_tpu_to_static_compile_seconds",
    "Wall time of the first call for a new to_static signature (the "
    "recording or trace, the fusion pass and the first run).",
    labelnames=("kind",))
_m_retrace_reason = _metrics.counter(
    "paddle_tpu_to_static_retrace_total",
    "Why a new signature retraced: new_input_shapes, new_static_args, or "
    "new_structure.", labelnames=("reason",))
_m_graph_break = _metrics.counter(
    "paddle_tpu_graph_break_total",
    "to_static recordings a graph break ended (the signature then runs "
    "under SOT partial-frame capture), labeled by its kind.",
    labelnames=("reason",))
_m_sot_frame = _metrics.counter(
    "paddle_tpu_sot_frame_total",
    "SOT frame executions: bypass = stitched segments (no Python), "
    "replay = recording Python replay.", labelnames=("mode",))


#: signatures a StaticFunction remembers as broken (the oldest goes first)
_GRAPH_BREAKS_MAX = 256


def in_capture_mode() -> bool:
    """Whether this thread is recording a ``to_static`` program (and no
    graph break has ended the recording)."""
    rec = active_capture()
    return rec is not None and rec.root.broken is None


def _describe(name: str, value):
    if isinstance(value, torch.Tensor):
        return ("tensor", tuple(value.shape), value.dtype, value.device)
    try:
        hash(value)
    except TypeError:
        raise TypeError(f"to_static: argument {name!r} is neither a tensor "
                        f"nor a hashable constant") from None
    return ("const", value)


def _is_layer(obj) -> bool:
    from ..nn.layer.layers import Layer
    return isinstance(obj, Layer)


def _kinds(args, kwargs) -> set:
    """The kinds of array among the arguments: "paddle", "torch",
    "numpy"."""
    found, todo = set(), [args, kwargs]
    while todo:
        o = todo.pop()
        if isinstance(o, Tensor):
            found.add("paddle")
        elif isinstance(o, torch.Tensor):
            found.add("torch")
        elif isinstance(o, np.ndarray):
            found.add("numpy")
        elif isinstance(o, (tuple, list)):
            todo.extend(o)
        elif isinstance(o, dict):
            todo.extend(o.values())
    return found


class StaticFunction:
    """A captured callable: one program per input signature."""

    def __init__(self, function: Callable, input_spec=None,
                 full_graph: bool = False):
        self._fn = function
        self._input_spec = input_spec
        self._full_graph = bool(full_graph)
        target = function.forward if isinstance(function, nn.Module) \
            else function
        functools.update_wrapper(self, target)
        self._sig = inspect.signature(target)
        self._programs: Dict[tuple, object] = {}
        #: the ``torch.fx.GraphModule`` the last fx-path call ran
        self.graph_module = None
        #: the fusion pass's stats of the last call's signature
        self.fusion_stats: Optional[dict] = None
        #: op-stream signatures a graph break sent to SOT, and why
        self._graph_breaks: Dict[tuple, str] = {}
        #: per broken signature: its segment plans, and its frame state
        #: (the last journal, whether it is stable, the frame guard)
        self._sot_caches: Dict[tuple, dict] = {}
        self._sot_frames: Dict[tuple, dict] = {}
        #: the last SOT call's {"segments", "compiled", "bypassed"} (and
        #: "fusion_rewritten" where the pass rewrote); None while no
        #: signature has broken
        self.sot_stats: Optional[dict] = None
        self._seen: list = []

    # ------------------------------------------------------------ common
    @property
    def graph_break_reason(self) -> Optional[str]:
        """Why the most recent breaking signature runs under SOT (None:
        none has broken)."""
        if not self._graph_breaks:
            return None
        return next(reversed(self._graph_breaks.values()))

    def __call__(self, *args, **kwargs):
        if isinstance(self._fn, nn.Module):
            return self._call_fx(args, kwargs)
        kinds = _kinds(args, kwargs)
        if {"paddle", "torch"} <= kinds:
            raise TypeError(
                "to_static: the arguments mix Paddle Tensors and "
                "torch.Tensors; a call takes one kind (the op-stream "
                "capture or the torch.fx one)")
        owner = getattr(self._fn, "__self__", None)
        if kinds - {"numpy"} == {"torch"} and not _is_layer(owner):
            return self._call_fx(args, kwargs)
        # a raw array is made anew each call: an SOT journal cannot
        # follow it, so such a frame is never bypassed (as in JAX)
        return self._call_stream(args, kwargs,
                                 trackable=not kinds & {"torch", "numpy"})

    def _compiled(self, kind_key, build):
        """Run ``build()`` (a new signature's first call) under the
        compile telemetry; returns its result."""
        kind = "initial" if not self._seen else "retrace"
        if _metrics.enabled():
            _m_compile.inc(kind=kind)
            if kind == "retrace":
                structure, statics, _shapes = kind_key
                reason = "new_structure"
                for s, st, _sh in self._seen:
                    if s == structure and st == statics:
                        reason = "new_input_shapes"
                        break
                    if s == structure:
                        reason = "new_static_args"
                _m_retrace_reason.inc(reason=reason)
        self._seen.append(kind_key)
        name = getattr(self, "__name__", "<fn>")
        with _trace.span(f"to_static_compile:{name}", "compile"), \
                _goodput.bill("compile"):
            t0 = time.perf_counter()
            out = build()
        seconds = time.perf_counter() - t0
        _sentinel.get().note_compile(kind=kind, seconds=seconds)
        if _metrics.enabled():
            _m_compile_time.observe(seconds, kind=kind)
        return out

    # ------------------------------------------------------- torch.fx path
    def _call_fx(self, args, kwargs):
        bound = self._sig.bind(*args, **kwargs)
        bound.apply_defaults()
        variadic = [p.name for p in self._sig.parameters.values()
                    if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
        if variadic:
            raise TypeError(f"to_static: *args/**kwargs parameters "
                            f"{variadic} cannot be traced")
        values = list(bound.arguments.values())
        fuse = fusion.enabled()
        modes = tuple(m.training for m in self._fn.modules()) \
            if isinstance(self._fn, nn.Module) else ()
        described = tuple(_describe(n, v) for n, v in bound.arguments.items())
        key = (fuse and fusion.fingerprint(), modes, amp_state(), described)
        program = self._programs.get(key)
        if program is None:
            concrete = {n: v for n, v in bound.arguments.items()
                        if not isinstance(v, torch.Tensor)}
            statics = (key[0], modes, key[2]) + tuple(
                d for d in described if d[0] == "const")
            program = self._programs[key] = self._compiled(
                ("fx", statics, described),
                lambda: trace_program(self._fn, values, concrete, fuse))
        self.graph_module, self.fusion_stats = program
        return self.graph_module(*values)

    # ---------------------------------------------------- op-stream path
    def _collect_params(self, args):
        """The Layer the function is bound to and the Layer arguments, and
        their parameters and buffers (a function's closed-over Layers are
        read live all the same, by the program)."""
        found = []
        owner = getattr(self._fn, "__self__", None)
        layers = ([owner] if _is_layer(owner) else []) + [
            a for a in args if _is_layer(a)]
        for layer in layers:
            found.extend(layer.parameters())
            found.extend(b for _, b in layer.named_buffers())
        return layers, found

    def _check_input_spec(self, tensors):
        """The Tensor arguments against the declared ``InputSpec``s: shape
        (-1 or None is any size) and dtype must match."""
        if not self._input_spec:
            return
        from ..core.dtype import dtype_name
        for spec, t in zip(self._input_spec, tensors):
            shape = getattr(spec, "shape", None)
            if shape is None:
                continue
            if len(shape) != len(t.shape) or any(
                    s not in (-1, None, d) for s, d in zip(shape, t.shape)):
                raise ValueError(
                    f"input shape {t.shape} does not match input_spec "
                    f"{tuple(shape)}")
            sdt = getattr(spec, "dtype", None)
            if sdt and str(sdt) != dtype_name(t.dtype):
                raise ValueError(f"input dtype {dtype_name(t.dtype)} does "
                                 f"not match input_spec {sdt}")

    def _call_stream(self, args, kwargs, trackable):
        if active_capture() is not None or active_sot() is not None:
            # inside an outer recording or SOT frame: it takes these ops
            return self._fn(*args, **kwargs)
        args = tuple(as_tensor(a) if isinstance(a, np.ndarray) else a
                     for a in args)
        structure, tensors = flatten((args, kwargs))
        self._check_input_spec(tensors)
        layers, params = self._collect_params(args)
        statics = (structure, fusion.enabled() and fusion.fingerprint(),
                   amp_state(),
                   tuple(s.training for layer in layers
                         for s in layer.sublayers(include_self=True)))
        try:
            hash(statics)
        except TypeError:
            raise TypeError("to_static: an argument is neither a Tensor "
                            "nor a hashable constant") from None
        first: Dict[int, int] = {}
        shapes = (tuple((tuple(t._data.shape), t._data.dtype,
                         t._data.device,
                         first.setdefault(id(t._data), k))   # aliasing
                        for k, t in enumerate(tensors)),
                  tuple((tuple(p._data.shape), p._data.dtype,
                         p._data.device) for p in params))
        key = (statics, shapes)
        if key in self._graph_breaks:
            return self._run_sot(key, args, kwargs, tensors, params,
                                 trackable)
        entry = self._programs.get(key)
        if entry is not None:
            program, self.fusion_stats = entry
            return program(*tensors)
        return self._compiled(("stream", statics, shapes),
                              lambda: self._record(key, args, kwargs,
                                                   tensors, params,
                                                   trackable))

    def _record(self, key, args, kwargs, tensors, params, trackable):
        # a recording that breaks has run the call up to the break: the
        # generators go back to where the call found them before it runs
        # again under SOT (the recorder puts back the tensors a lowering
        # changed in place, such as batch norm's running statistics)
        rng = None if self._full_graph else generator.snapshot()
        analysis = None
        if _perf.capture_enabled():
            # FLAGS_perf_capture: the recording runs once under the
            # analysis (FlopCounterMode, the aten ops' bytes, the memory
            # the call took), the port's counterpart of the JAX
            # package's cost and memory analysis of the compiled program
            got = {}

            def recording():
                got["r"] = fusion.rewrite_traced(
                    lambda: self._fn(*args, **kwargs), tensors,
                    self._full_graph)
                return got["r"][0]
            _, analysis = _perf.device.analyze_call(recording)
            out, program, stats, rec = got["r"]
        else:
            out, program, stats, rec = fusion.rewrite_traced(
                lambda: self._fn(*args, **kwargs), tensors,
                self._full_graph)
        if program is None:
            reason = rec.broken
            if _metrics.enabled():
                _m_graph_break.inc(reason="GraphBreak")
            if len(self._graph_breaks) >= _GRAPH_BREAKS_MAX:
                evicted = next(iter(self._graph_breaks))
                self._graph_breaks.pop(evicted)
                # the segment plans and journal go with the signature
                self._sot_caches.pop(evicted, None)
                self._sot_frames.pop(evicted, None)
            self._graph_breaks[key] = reason
            warnings.warn(
                f"to_static graph break in "
                f"{getattr(self, '__name__', '<fn>')!r}: switching to SOT "
                f"partial-frame capture ({reason}); the op sequences "
                f"between breaks still run as cached segments. Use "
                f"in-graph control flow (paddle.where, static.nn.cond) to "
                f"capture the whole function.", stacklevel=3)
            self.fusion_stats = None
            # the recording ended at the break: the call runs again from
            # its start, drawing what eager would draw and updating each
            # buffer once
            generator.restore(rng)
            return self._run_sot(key, args, kwargs, tensors, params,
                                 trackable)
        self._programs[key] = (program, stats)
        self.fusion_stats = stats
        if analysis is not None:
            _perf.record_compiled(
                "to_static", getattr(self, "__name__", "<fn>"), analysis)
        return out

    # ---------------------------------------------------------------- SOT
    def _frame_guard(self):
        """The frame-level guard: the closure and default values the
        frame reaches, its owner's scalar attributes, and the grad mode
        (the bypass runs the segments' lowerings under the grad mode
        they were deferred under)."""
        from . import sot
        fn = self._fn
        g = sot.fn_fingerprint(fn, depth=2)
        owner = getattr(fn, "__self__", None)
        if owner is not None:
            g += "#" + sot._const_repr(owner, 1)
        return g + "#" + str(torch.is_grad_enabled())

    def _run_sot(self, key, args, kwargs, tensors, params, trackable):
        """Partial-frame capture of a signature that broke (reference
        jit/sot/translate.py): the ops before each host read run as one
        cached segment, the read runs eagerly, capture resumes after it.
        Once two consecutive replays journal the same segment graph,
        later calls check one frame guard and run the stitched segments
        directly; a guard miss falls back to a recording replay."""
        from . import sot
        cache = self._sot_caches.setdefault(key, {})
        state = self._sot_frames.setdefault(
            key, {"journal": None, "stable": False, "guard": None})
        input_arrays = [t._data for t in tensors]
        guard = self._frame_guard()

        journal = state["journal"]
        if (state["stable"] and journal is not None and journal.eligible
                and state["guard"] == guard):
            ok, packed, _why = sot.replay_frame(journal, cache,
                                                input_arrays, params)
            if ok:
                structure, leaves = packed
                out = unflatten(structure, [
                    Tensor(arr, stop_gradient=stop)
                    for arr, stop in leaves])
                self.sot_stats = {"segments": len(journal.segments),
                                  "compiled": 0, "bypassed": True}
                if _metrics.enabled():
                    _m_sot_frame.inc(mode="bypass")
                return out
            # a guard missed: back to a recording replay
            state["stable"] = False
            state["journal"] = None

        new_journal = sot.FrameJournal()
        if not trackable:
            new_journal.mark_ineligible("raw array input")
        cap = sot.capture(cache, journal=new_journal,
                          input_arrays=input_arrays, params=params)
        with cap:
            out = self._fn(*args, **kwargs)
        structure, leaves = flatten(out)
        cap.finalize_journal(leaves, structure)
        prev = state["journal"]
        state["stable"] = bool(
            new_journal.eligible and prev is not None and prev.eligible
            and state["guard"] == guard
            and prev.structure_key() == new_journal.structure_key()
            and new_journal.segments)
        state["journal"] = new_journal if new_journal.eligible else None
        state["guard"] = guard
        self.sot_stats = dict(cap.stats, bypassed=False)
        if _metrics.enabled():
            _m_sot_frame.inc(mode="replay")
        return out

    @property
    def code(self):
        return inspect.getsource(self._fn)


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, full_graph: bool = False):
    """Capture ``function``; usable as a decorator. A Paddle-API ``Layer``
    has its ``forward`` wrapped and is returned; a ``torch.nn.Module`` or
    a function gives a ``StaticFunction``. ``input_spec`` (``InputSpec``s
    of the Tensor arguments) is checked on every call; ``full_graph=True``
    makes a graph break raise. ``build_strategy`` and ``backend`` are the
    JAX package's signature and have no effect. A function marked
    ``not_to_static`` is returned as it is."""
    def decorate(fn):
        if getattr(fn, "_not_to_static", False):
            return fn
        if _is_layer(fn):
            fn.forward = StaticFunction(fn.forward, input_spec, full_graph)
            return fn
        return StaticFunction(fn, input_spec, full_graph)
    return decorate(function) if function is not None else decorate


def not_to_static(fn):
    """Mark ``fn`` to run eagerly: ``to_static`` returns it as it is."""
    fn._not_to_static = True
    return fn


def ignore_module(modules):
    """Accepted for the JAX package's API; has no effect (as there)."""
    return None


# ------------------------------------------------------------- jit.save
flags.define_flag("compile_cache", False,
                  "The persistent compile cache; the port's is a later "
                  "slice, so a TranslatedLayer raises while it is set.")

#: the ``format`` key of a ``.pdmodel`` this package writes
ARTIFACT_FORMAT = "paddle_tpu_torch.jit/1"
#: example sizes of the -1 axes of an ``InputSpec`` (axis i takes the
#: i-th): at least 2 (export specializes sizes 0 and 1) and unlike the
#: static sizes models have, so that no axis is equated by accident
_EXAMPLE_SIZES = (5, 7, 11, 13, 17, 19, 23, 29)


class ArtifactVersionError(RuntimeError):
    """A ``jit.save`` artifact this runtime cannot load: another format
    (a JAX ``paddle_tpu.jit`` artifact), or a program that fails to
    deserialize under another torch version. Re-export it with
    ``jit.save`` on the current toolchain."""


def _unwrap(out):
    if isinstance(out, Tensor):
        return out._data
    if isinstance(out, (list, tuple)):
        return type(out)(_unwrap(o) for o in out)
    if isinstance(out, dict):
        return {k: _unwrap(v) for k, v in out.items()}
    return out


def _wrap(out):
    if isinstance(out, torch.Tensor):
        return Tensor(out)
    if isinstance(out, (list, tuple)):
        return type(out)(_wrap(o) for o in out)
    if isinstance(out, dict):
        return {k: _wrap(v) for k, v in out.items()}
    return out


def _example_inputs(input_spec, device):
    """InputSpec / Tensor / ndarray entries -> (example tensors on
    ``device``, their ``dynamic_shapes``). A -1 at axis i becomes the
    ``torch.export.Dim`` ``d<i>``, one symbol shared by every input, so
    that inputs with dynamic batch dims stay broadcast-compatible (the
    JAX package's symbolic scope)."""
    from ..core.dtype import convert_dtype

    dims: Dict[int, object] = {}
    examples, dynamic = [], []
    for spec in input_spec:
        if isinstance(spec, Tensor):
            examples.append(spec._data.detach().to(device))
            dynamic.append(None)
            continue
        if isinstance(spec, (np.ndarray, torch.Tensor)):
            examples.append(torch.as_tensor(spec).to(device))
            dynamic.append(None)
            continue
        shape = tuple(-1 if s is None else int(s) for s in spec.shape)
        marks = {}
        for i, s in enumerate(shape):
            if s == -1:
                if i not in dims:
                    dims[i] = torch.export.Dim(f"d{i}", min=1)
                marks[i] = dims[i]
        size = tuple(_EXAMPLE_SIZES[i % len(_EXAMPLE_SIZES)] if s == -1
                     else s for i, s in enumerate(shape))
        examples.append(torch.zeros(size, dtype=convert_dtype(spec.dtype),
                                    device=device))
        dynamic.append(marks or None)
    return examples, dynamic


class _Program(torch.nn.Module):
    """``fn`` as a pure function of (parameters and buffers, inputs), for
    ``torch.export``: the state's payloads are swapped into the Layer's
    Tensors for the trace and restored after it (the JAX ``pure``)."""

    def __init__(self, fn, named):
        super().__init__()
        self._target = fn
        self._named = named

    def forward(self, params, inputs):
        originals = []
        for k, t in self._named.items():
            originals.append((t, t._data))
            if k in params:
                t._data = params[k]
        try:
            return _unwrap(self._target(*[Tensor(x) for x in inputs]))
        finally:
            for t, d in originals:
                t._data = d


def save(layer, path, input_spec=None, **configs):
    """Export the program of ``layer`` (a Paddle-API ``Layer``, a function
    on Paddle Tensors, or a ``StaticFunction``, whose ``input_spec`` is
    the default) with ``torch.export`` and write the artifact: ``path +
    ".pdmodel"`` (the program and its calling convention, a pickle of
    builtins only) and ``path + ".pdparams"`` (the state dict, the v2
    checkpoint file). ``jit.load`` runs it without the model class.

    The trace runs under ``torch.no_grad()`` on detached payloads, with
    the layer in eval mode, so attention is the K1 op
    (``paddle_tpu_torch::flash_attention_fwd``), which the program holds
    as a node; a -1 in an ``InputSpec`` is a dynamic dim. A host read of
    a traced value (``.item()``, ``.numpy()``, the ``FLAGS_check_nan_inf``
    scan) raises ``GraphBreak`` naming it."""
    import io

    from ..core.place import current_device
    from ..core.tensor import export_scope
    from ..framework.io import save as _save

    if isinstance(layer, nn.Module):
        raise TypeError(
            "jit.save takes Paddle-API Layers and functions on Paddle "
            "Tensors; the torch-level models wait for their rebase on "
            "nn.Layer")
    fn = layer.forward if hasattr(layer, "forward") else layer
    if isinstance(fn, StaticFunction):
        if input_spec is None:
            input_spec = fn._input_spec
        fn = fn._fn
    if input_spec is None:
        raise ValueError(
            "jit.save needs input_spec (list of InputSpec / example "
            "tensors) to trace the program")

    state = layer.state_dict() if hasattr(layer, "state_dict") else {}
    named = {}
    if hasattr(layer, "named_parameters"):
        named.update(dict(layer.named_parameters()))
    if hasattr(layer, "named_buffers"):
        named.update(dict(layer.named_buffers()))
    params = {k: v._data.detach() for k, v in state.items()}
    device = next(iter(params.values())).device if params \
        else current_device()

    was_training = getattr(layer, "training", False)
    if hasattr(layer, "eval"):
        layer.eval()
    t0 = time.perf_counter()
    try:
        examples, dynamic = _example_inputs(list(input_spec), device)
        with torch.no_grad(), export_scope():
            exported = torch.export.export(
                _Program(fn, named), (params, examples),
                dynamic_shapes=({k: None for k in params}, dynamic),
                strict=False)
    finally:
        if was_training and hasattr(layer, "train"):
            layer.train()

    t1 = time.perf_counter()
    # the example inputs hold the whole state: keep it in .pdparams alone
    exported.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    d = os.path.dirname(str(path))
    if d:
        os.makedirs(d, exist_ok=True)
    with open(str(path) + ".pdmodel", "wb") as f:
        pickle.dump({"format": ARTIFACT_FORMAT,
                     "n_inputs": len(examples),
                     "program": buf.getvalue(),
                     "torch_version": str(torch.__version__),
                     "platform": device.type}, f)
    _save(state, str(path) + ".pdparams")
    save.seconds = {"export": t1 - t0, "write": time.perf_counter() - t1}


#: the last ``save``'s seconds: the trace ("export") and the files
save.seconds = {}


class TranslatedLayer:
    """A loaded program, callable without the original model class
    (reference: python/paddle/jit/translated_layer.py TranslatedLayer):
    the exported program on one device with the state it reads."""

    def __init__(self, exported, state, n_inputs: int = 1,
                 device: Optional[torch.device] = None):
        self._exported = exported
        self._module = exported.module()
        self._state = dict(state)
        self.n_inputs = n_inputs
        self.device = device
        self.training = False

    def _payloads(self):
        return {k: (v._data if isinstance(v, Tensor) else v)
                for k, v in self._state.items()}

    def __call__(self, *inputs):
        if flags.get_flag("compile_cache"):
            raise NotImplementedError(
                "later slice: the persistent compile cache "
                "(FLAGS_compile_cache) for TranslatedLayer")
        arrays = [i._data if isinstance(i, Tensor) else
                  torch.as_tensor(i, device=self.device) for i in inputs]
        with torch.no_grad():
            out = self._module(self._payloads(), arrays)
        return _wrap(out)

    forward = __call__

    def precompile(self, input_spec):
        raise NotImplementedError(
            "later slice: TranslatedLayer.precompile waits for the "
            "persistent compile cache and AOT")

    def state_dict(self):
        return dict(self._state)

    def set_state_dict(self, state):
        for k, v in state.items():
            if k in self._state:
                old = self._state[k]
                d = v._data if isinstance(v, Tensor) else torch.as_tensor(v)
                self._state[k] = Tensor(d.to(device=old._data.device,
                                             dtype=old._data.dtype))

    def eval(self):
        self.training = False
        return self

    def train(self):
        raise RuntimeError(
            "TranslatedLayer holds an inference program; retraining "
            "requires the original model class (reference parity)")


def load(path, device=None, **configs):
    """Load a ``jit.save`` artifact as a ``TranslatedLayer`` on ``device``
    (default: the current device, ``set_device``), the program moved
    there, so that an artifact saved on the CPU launches the kernels on
    the card; with no ``.pdmodel`` the state dict alone. A foreign
    artifact, or one that fails to deserialize under another torch
    version, raises ``ArtifactVersionError``."""
    import io

    from torch.export.passes import move_to_device_pass

    from ..core.place import current_device, device_guard, resolve_device
    from ..framework.io import load as _load
    from ..ops.cuda import flash_attention as _k1   # noqa: F401 (the op)

    path = str(path)
    dev = current_device() if device is None else resolve_device(device)
    t0 = time.perf_counter()
    with device_guard("cpu" if dev.type == "cpu" else f"gpu:{dev.index}"):
        state = _load(path + ".pdparams")
    t1 = time.perf_counter()
    model_file = path + ".pdmodel"
    if not os.path.exists(model_file):
        return state
    with open(model_file, "rb") as f:
        blob = _BuiltinsUnpickler(f).load()
    fmt = str(blob.get("format", "")) if isinstance(blob, dict) else ""
    if not fmt.startswith("paddle_tpu_torch.jit/"):
        raise ArtifactVersionError(
            f"{model_file!r} is not a paddle_tpu_torch.jit artifact "
            f"(format={fmt!r}) — re-export it with this package's "
            f"jit.save")
    try:
        exported = torch.export.load(io.BytesIO(blob["program"]))
    except Exception as e:
        saved = blob.get("torch_version")
        if saved != str(torch.__version__):
            raise ArtifactVersionError(
                f"cannot load {model_file!r}: the program was exported "
                f"with torch {saved} on {blob.get('platform', '?')}, this "
                f"runtime is torch {torch.__version__}. Re-export the "
                f"artifact with jit.save on the current toolchain.") from e
        raise
    exported = move_to_device_pass(exported, str(dev))
    layer = TranslatedLayer(exported, state,
                            n_inputs=int(blob.get("n_inputs", 1)), device=dev)
    load.seconds = {"state": t1 - t0, "program": time.perf_counter() - t1}
    return layer


#: the last ``load``'s seconds: the state dict and the program
load.seconds = {}


_BUILTINS = frozenset({"bytearray", "bytes", "str", "int", "float",
                       "bool", "complex", "dict", "list", "tuple", "set",
                       "frozenset"})


class _BuiltinsUnpickler(pickle.Unpickler):
    """A ``.pdmodel`` holds builtins only: refuse any other class."""

    def find_class(self, module, name):
        if module == "builtins" and name in _BUILTINS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"a .pdmodel holds builtins only, found {module}.{name}")
