"""Eager op dispatcher (counterpart of ``paddle_tpu/core/dispatch.py``).

``call`` runs one Paddle-API op: it unwraps the input Tensors' torch
payloads, casts them for amp (``amp_cast`` with the JAX package's op
lists), detaches the inputs ``differentiable_mask`` marks as not
differentiable, runs the op's plain torch body, wraps the result, and
then runs the side channels: the ``FLAGS_check_nan_inf`` scan (naming
the op), the ``FLAGS_enable_metrics`` latency histogram
(``paddle_tpu_dispatch_op_latency_seconds``, the JAX package's name),
the trace span and the ``register_op_hook`` taps.

The gradient is torch autograd's: the body's torch ops record their own
graph while grad is enabled, and a cast is itself an autograd op, so
cotangents come back in each input's own dtype (what the JAX dispatcher
folds into the differentiated function by hand). The grad mode is
torch's (``no_grad``, ``enable_grad``, ``set_grad_enabled``), so the
port's torch-level functionals and its Paddle API see one mode.

The JAX dispatcher's other parts have no counterpart here:

* the eager compiled-lowering cache and the lazy VJP
  (``_jit_cached_call``, ``_closure_cache_key``, ``_lazy_vjp``): they
  exist because JAX eager dispatch is slow; torch runs an op directly
  and records its backward as it goes;
* the SOT ``LazyArray`` path (lazy capture of eager ops into segments):
  the port's ``to_static`` records a whole call through the recorder
  taps below, and a graph break runs that signature eagerly;
* the branch trace (``enter_branch_trace``): it waits for the port of
  ``static/nn`` control flow;
* the op-cost accumulator (``FLAGS_perf_op_cost``): it waits for
  ``observability/perf``.

The recorder taps (``register_recorder_hook``, per thread) are
``jit.to_static``'s: a hook gets ``(op_name, fn, tensor_inputs,
out_tensors, attrs)``, where ``fn`` replays the op on new payloads
(``call`` runs it again with the same amp cast): the lowering with its
attrs bound and the inputs that ``differentiable_mask`` excludes
detached. The export hooks (``register_export_hook``) are ONNX
export's: a hook gets ``(op_name, tensor_inputs, out_tensors, attrs)``
with the op's semantic parameters (``export_attrs()``: stride, padding,
axis, ...) merged into its attrs; an op builds them only while a hook
is registered. ``quiet_scope`` silences every tap
for the ops inside it.
"""
from __future__ import annotations

import functools
import inspect
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..amp.state import amp_cast
from . import flags
from .tensor import GraphBreak, Tensor, exporting
from ..observability import metrics as _metrics
from ..observability import trace as _trace

_perf_counter = time.perf_counter

flags.define_flag("check_nan_inf", False,
                  "Scan op outputs for NaN/Inf after every op.")
flags.define_flag("check_nan_inf_level", 0,
                  "0: error on NaN/Inf; >0: log only.")

# hot-path mirror of the flags dispatch reads per op
_hot = {"check_nan_inf": flags.get_flag("check_nan_inf")}
flags.on_change("check_nan_inf",
                lambda v: _hot.__setitem__("check_nan_inf", v))

_m_op_latency = _metrics.histogram(
    "paddle_tpu_dispatch_op_latency_seconds",
    "Host wall time per eager op dispatch (lowering + tape + side "
    "channels).", labelnames=("op",))
_m_hook_overhead = _metrics.histogram(
    "paddle_tpu_dispatch_hook_seconds",
    "Host time spent inside op/recorder/export hooks per dispatch.")


# ------------------------------------------------------------- grad mode
def grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool) -> bool:
    """Set the grad mode; returns the previous one."""
    prev = torch.is_grad_enabled()
    torch.set_grad_enabled(mode)
    return prev


class no_grad:
    """Context manager and decorator (paddle.no_grad)."""

    def __enter__(self):
        self._prev = set_grad_enabled(False)
        return self

    def __exit__(self, *exc):
        set_grad_enabled(self._prev)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            with no_grad():
                return fn(*a, **k)
        return wrapper


class enable_grad:
    def __enter__(self):
        self._prev = set_grad_enabled(True)
        return self

    def __exit__(self, *exc):
        set_grad_enabled(self._prev)
        return False


class set_grad_enabled_ctx:
    def __init__(self, mode: bool):
        self._mode = mode

    def __enter__(self):
        self._prev = set_grad_enabled(self._mode)
        return self

    def __exit__(self, *exc):
        set_grad_enabled(self._prev)
        return False


# ----------------------------------------------------------------- hooks
_op_hooks: List[Callable] = []
_hook_adapters: Dict[Callable, List[Callable]] = {}
# program capture is per thread: a capture on thread A must not record
# the ops that thread B dispatches
_tls = threading.local()


def _recorder_hooks() -> List[Callable]:
    hooks = getattr(_tls, "recorders", None)
    if hooks is None:
        hooks = _tls.recorders = []
    return hooks


def register_recorder_hook(fn):
    """Register ``fn(op_name, fn, tensor_inputs, out_tensors, attrs)`` for
    this thread's ops."""
    _recorder_hooks().append(fn)


def unregister_recorder_hook(fn):
    hooks = _recorder_hooks()
    if fn in hooks:
        hooks.remove(fn)


class quiet_scope:
    """Silence the side channels (op and recorder taps, metrics, trace,
    the NaN/Inf scan) for the ops dispatched inside the block."""

    def __enter__(self):
        self._prev = getattr(_tls, "quiet", False)
        _tls.quiet = True
        return self

    def __exit__(self, *exc):
        _tls.quiet = self._prev
        return False


_export_hooks: List[Callable] = []


def register_export_hook(fn):
    """Register ``fn(op_name, tensor_inputs, out_tensors, export_attrs)``
    (ONNX export's tracer): the op's semantic parameters merged into its
    attrs."""
    _export_hooks.append(fn)


def unregister_export_hook(fn):
    try:
        _export_hooks.remove(fn)
    except ValueError:
        pass


def register_op_hook(fn):
    """Register a per-op tap called as ``fn(op_name, inputs, outputs,
    attrs, duration_s)``. Legacy 4-positional hooks are adapted so older
    taps keep working without seeing the latency argument."""
    target = fn
    try:
        params = inspect.signature(fn).parameters.values()
        positional = [p for p in params
                      if p.kind in (p.POSITIONAL_ONLY,
                                    p.POSITIONAL_OR_KEYWORD)]
        has_var = any(p.kind == p.VAR_POSITIONAL for p in params)
        if not has_var and len(positional) == 4:
            def target(op, ins, outs, attrs, dur, __fn=fn):
                return __fn(op, ins, outs, attrs)
            _hook_adapters.setdefault(fn, []).append(target)
    except (TypeError, ValueError):
        pass
    _op_hooks.append(target)
    return fn


def unregister_op_hook(fn):
    adapters = _hook_adapters.get(fn)
    target = fn
    if adapters:
        target = adapters.pop()
        if not adapters:
            del _hook_adapters[fn]
    try:
        _op_hooks.remove(target)
    except ValueError:
        pass


def _check_nan_inf(op_name: str, outs: Sequence[torch.Tensor]) -> None:
    if exporting():
        raise GraphBreak(f"the FLAGS_check_nan_inf scan of op '{op_name}' "
                         f"reads its output on the host while jit.save "
                         f"exports a program")
    for o in outs:
        if not (o.is_floating_point() or o.is_complex()):
            continue
        if not bool(torch.isfinite(o).all()):
            msg = f"NaN or Inf found in output of op '{op_name}'"
            if flags.get_flag("check_nan_inf_level") == 0:
                raise FloatingPointError(msg)
            print(f"[paddle_tpu][nan_inf] {msg}")


def _replayable(fn: Callable, attrs: dict,
                mask: Optional[Sequence[bool]]) -> Callable:
    """``fn`` as ``call`` ran it, for a recorder: attrs bound, the inputs
    that ``mask`` excludes detached."""
    if not attrs and mask is None:
        return fn

    def bound(*arrays):
        if mask is not None:
            arrays = [a.detach() if not keep and isinstance(a, torch.Tensor)
                      else a for a, keep in zip(arrays, mask)]
        return fn(*arrays, **attrs)
    return bound


# -------------------------------------------------------------- dispatch
def call(op_name: str, fn: Callable, tensor_inputs: Sequence[Tensor],
         attrs: Optional[dict] = None, multi_output: bool = False,
         differentiable_mask: Optional[Sequence[bool]] = None,
         export_attrs: Optional[Callable[[], dict]] = None):
    """Run one op: ``fn(*payloads, **attrs)`` over the torch payloads of
    ``tensor_inputs`` (cast for amp; an input whose
    ``differentiable_mask`` entry is False is detached). Returns a Tensor,
    or a list of Tensors when ``fn`` returns a tuple or list (what
    ``fn`` returns decides; ``multi_output`` is the JAX signature's).
    ``export_attrs()`` gives the op's semantic parameters, for the export
    hooks only: it is called, before the body, only when one is
    registered."""
    attrs = attrs or {}
    quiet = getattr(_tls, "quiet", False)
    exported = None
    if _export_hooks and not quiet:
        exported = dict(attrs)
        if export_attrs is not None:
            exported.update(export_attrs())
    timed = (bool(_op_hooks) or _metrics.enabled() or _trace.active()) \
        and not quiet
    t0 = _perf_counter() if timed else 0.0

    arrays = amp_cast(op_name, *[t._data for t in tensor_inputs])
    if differentiable_mask is not None:
        arrays = [a.detach() if not keep and isinstance(a, torch.Tensor)
                  else a for a, keep in zip(arrays, differentiable_mask)]
    outs = fn(*arrays, **attrs)

    single = not isinstance(outs, (tuple, list))
    out_list = [outs] if single else list(outs)
    out_tensors = [Tensor(o) for o in out_list]

    if _hot["check_nan_inf"] and not quiet:
        _check_nan_inf(op_name, out_list)
    recorders = getattr(_tls, "recorders", None)
    if recorders and not quiet:
        bound = _replayable(fn, attrs, differentiable_mask)
        for hook in list(recorders):
            hook(op_name, bound, tensor_inputs, out_tensors, attrs)
    if timed:
        dur = _perf_counter() - t0
        if _metrics.enabled():
            _m_op_latency.observe(dur, op=op_name)
        if _trace.active():
            _trace.add_complete(op_name, "dispatch", t0, t0 + dur)
        th0 = _perf_counter() if _op_hooks and _metrics.enabled() else 0.0
        for hook in _op_hooks:
            hook(op_name, tensor_inputs, out_tensors, attrs, dur)
        if th0:
            _m_hook_overhead.observe(_perf_counter() - th0)
    if exported is not None:
        for hook in list(_export_hooks):
            hook(op_name, tensor_inputs, out_tensors, exported)
    return out_tensors[0] if single else out_tensors
