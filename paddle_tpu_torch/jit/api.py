"""``to_static`` (counterpart of ``paddle_tpu/jit/api.py``).

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
  parameter's payload, ...) raises with ``full_graph=True``; with
  ``full_graph=False`` it warns, sets ``graph_break_reason``, counts
  ``paddle_tpu_graph_break_total`` and runs that signature eagerly from
  then on (the JAX package's SOT segments are a later slice). A replay's
  outputs carry torch autograd, so they are differentiable; the JAX
  package's are ``stop_gradient`` (ROADMAP Queue 3).

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
"""
from __future__ import annotations

import functools
import inspect
import time
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..amp.state import amp_state
from ..compile import fusion
from ..compile.fusion.fx import trace_program
from ..core.tensor import Tensor, active_capture, as_tensor
from ..observability import goodput as _goodput
from ..observability import metrics as _metrics
from ..observability import sentinel as _sentinel
from ..observability import trace as _trace
from .program import flatten

__all__ = ["StaticFunction", "to_static", "not_to_static", "ignore_module",
           "in_capture_mode"]

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
    "to_static recordings a graph break ended, labeled by its kind.",
    labelnames=("reason",))


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
    """The kinds of tensor among the arguments: "paddle", "torch"."""
    found, todo = set(), [args, kwargs]
    while todo:
        o = todo.pop()
        if isinstance(o, Tensor):
            found.add("paddle")
        elif isinstance(o, torch.Tensor):
            found.add("torch")
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
        #: op-stream signatures a graph break sent to eager, and why
        self._graph_breaks: Dict[tuple, str] = {}
        self._seen: list = []

    # ------------------------------------------------------------ common
    @property
    def graph_break_reason(self) -> Optional[str]:
        """Why the most recent breaking signature runs eagerly (None:
        none has broken)."""
        if not self._graph_breaks:
            return None
        return next(reversed(self._graph_breaks.values()))

    def __call__(self, *args, **kwargs):
        if isinstance(self._fn, nn.Module):
            return self._call_fx(args, kwargs)
        kinds = _kinds(args, kwargs)
        if kinds == {"paddle", "torch"}:
            raise TypeError(
                "to_static: the arguments mix Paddle Tensors and "
                "torch.Tensors; a call takes one kind (the op-stream "
                "capture or the torch.fx one)")
        owner = getattr(self._fn, "__self__", None)
        if kinds == {"torch"} and not _is_layer(owner):
            return self._call_fx(args, kwargs)
        return self._call_stream(args, kwargs)

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
        """The parameters and buffers of the Layer the function is bound
        to and of Layer arguments (a function's closed-over Layers are
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

    def _call_stream(self, args, kwargs):
        if active_capture() is not None:
            # inside an outer recording: its recorder takes these ops
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
            return self._fn(*args, **kwargs)
        entry = self._programs.get(key)
        if entry is not None:
            program, self.fusion_stats = entry
            return program(*tensors)
        return self._compiled(("stream", statics, shapes),
                              lambda: self._record(key, args, kwargs,
                                                   tensors))

    def _record(self, key, args, kwargs, tensors):
        out, program, stats, rec = fusion.rewrite_traced(
            lambda: self._fn(*args, **kwargs), tensors, self._full_graph)
        if program is None:
            reason = rec.broken
            if _metrics.enabled():
                _m_graph_break.inc(reason="GraphBreak")
            if len(self._graph_breaks) >= _GRAPH_BREAKS_MAX:
                self._graph_breaks.pop(next(iter(self._graph_breaks)))
            self._graph_breaks[key] = reason
            warnings.warn(
                f"to_static graph break in "
                f"{getattr(self, '__name__', '<fn>')!r} ({reason}): this "
                f"signature runs eagerly", stacklevel=3)
            self.fusion_stats = None
            return out
        self._programs[key] = (program, stats)
        self.fusion_stats = stats
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
