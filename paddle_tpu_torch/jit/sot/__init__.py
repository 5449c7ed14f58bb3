"""SOT partial-frame capture (counterpart of
``paddle_tpu/jit/sot/__init__.py``).

Reference contract: python/paddle/jit/sot/translate.py (the frame-eval
entry), sot/symbolic/statement_ir.py (the captured op statements) and
symbolic/compile_cache.py (the guarded per-site cache): a frame that
``to_static`` cannot capture whole runs its op sequences between the
breaks as captured programs, runs each break eagerly, and resumes
capture after it.

No bytecode is simulated. Python runs the frame as it is, but the ops
the dispatcher (``core.dispatch.call``) takes while a ``capture`` is
active do not run: each joins the **segment** under construction and
returns a Tensor whose payload is a ``LazyArray``, a placeholder with
the shape, dtype, device and ``requires_grad`` the op would give. Those
come from running the op's lowering once on meta tensors (no data, no
kernel), cached by (op, attributes, input shapes/dtypes, grad mode, amp
state). A host read of a pending value (``numpy``, ``item``, ``tolist``,
``bool``/``float``/``int``, ``cpu``), any other graph break
(``core.tensor.graph_break``: a backward, an optimizer step, a random
draw outside the dispatcher), and the end of the frame **flush** the
segment: its ops become one ``jit.program.Program``, run through
``dispatch.call`` (each under the amp state and grad mode it was
deferred under, so autograd and amp behave as in eager code), and every
live placeholder is bound to its value in each Tensor that holds it.
Capture then resumes in a fresh segment. A frame with one host read in
the middle gives two segments.

Cache: a flushed segment's plan is keyed by (site index, the op
sequence with each op's attributes, lowering fingerprint, amp state and
grad mode, the external inputs' shapes, dtypes and devices, the values
live at the flush) and, with ``FLAGS_enable_fusion``, the fusion pass's
fingerprint.
A miss runs the graph-fusion pass (``compile/fusion.fuse_sot_nodes``)
and stores the plan; a hit reuses the plan with this call's lowerings
(a closure's tensors are this call's). An op whose output shape depends
on the data (``nonzero``, ``unique``, ...) cannot run on meta tensors:
it flushes the segment and runs on the values, an implicit break.

Steady-state bypass: while a frame replays, a ``FrameJournal`` records
its segment graph: each segment's cache key, where each external
payload came from (frame input, parameter, an earlier segment's output,
a constant the glue made), the scalars Python read at the breaks, and
how the frame's return value maps onto segment outputs. Two consecutive
replays with the same journal make the frame stable; later calls check
one frame guard and run the stitched segments without Python, reading
each parameter's payload live and value-guarding every break scalar. A
guard miss falls back to a Python replay. Frames whose outputs carry
autograd history, whose break values are not scalars, or whose glue
swaps a parameter's payload stay on replay.

Where the port differs from the JAX package: the JAX segment is one
``jax.jit`` program and its placeholder an ``eval_shape`` aval; here a
segment is a step list of eager ops (with the fused ops where the pass
rewrote it) and a placeholder's aval a meta tensor. The gradient is
torch autograd's, recorded as the flush runs, so a ``backward()`` after
the frame sees one graph across segments. The persistent compile
cache's hooks (the JAX ``_pcc_*``) and the program verifier are not
ported.
"""
from __future__ import annotations

import functools
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ...amp.state import amp_cast, amp_state
from ...core import tensor as _tensor
from ...core.dispatch import _replayable, quiet_scope
from ...observability import goodput as _goodput
from ...observability import metrics as _metrics
from ...observability import perf as _perf
from ...observability import trace as _trace
from ..program import Program, _Step

__all__ = ["LazyArray", "Segment", "FrameJournal", "capture", "replay_frame",
           "record_or_none", "active", "current_segment", "fn_fingerprint",
           "SEGMENT_CACHE_MAX"]

_m_segment_cache = _metrics.counter(
    "paddle_tpu_sot_segment_cache_total",
    "SOT segment cache events at flush: hit = a cached segment plan "
    "reused, miss = the segment planned (and fused) afresh.",
    labelnames=("event",))
_m_segment_compile_time = _metrics.histogram(
    "paddle_tpu_sot_segment_compile_seconds",
    "Wall time to plan (fuse) and first-run one flushed SOT segment.")

#: bound on segment plans per (StaticFunction, signature) cache
SEGMENT_CACHE_MAX = 128
#: bound on the shape-inference cache (op, attributes, input avals)
_INFER_MAX = 8192

_PRIM = (int, float, bool, str, bytes, complex, type(None))


def _scalar_repr(payload) -> Optional[str]:
    """The value of a one-element host payload, for a guard key; None
    where reading it would wait on the card (or it is no payload)."""
    if isinstance(payload, torch.Tensor):
        if payload.device.type != "cpu" or payload.is_meta:
            return None
        return repr(payload.detach().reshape(()).item())
    try:
        return repr(np.asarray(payload).item())
    except Exception:
        return None


def _const_repr(v, depth: int) -> str:
    """Stable repr of a captured Python constant for guard keys."""
    if isinstance(v, _PRIM) or isinstance(v, (np.integer, np.floating,
                                              np.bool_)):
        return repr(v)
    if isinstance(v, (tuple, list)):
        if depth <= 0:
            return f"<seq:{len(v)}>"
        return "[" + ",".join(_const_repr(x, depth - 1) for x in v) + "]"
    if isinstance(v, dict):
        if depth <= 0:
            return f"<dict:{len(v)}>"
        try:
            items = sorted(v.items())
        except TypeError:
            items = list(v.items())
        return "{" + ",".join(f"{k!r}:{_const_repr(x, depth - 1)}"
                              for k, x in items) + "}"
    if isinstance(v, (torch.dtype, torch.device, torch.Size)):
        return repr(v)
    if hasattr(v, "shape") and hasattr(v, "dtype"):
        try:
            shape = tuple(v.shape)
        except TypeError:
            # ".shape" is a method, not array metadata (duck-type miss)
            return f"<{type(v).__name__}>"
        size = int(np.prod(shape)) if shape else 1
        payload = getattr(v, "_data", v)
        if type(payload) is LazyArray:
            if payload._value is None:
                # a pending node a lowering closes over (the control-flow
                # ops close over branch Tensors): reading it would flush
                # the segment while it records; its value flows through
                # the op's inputs, so shape/dtype guard
                return f"<arr:{shape}:{v.dtype}:lazy>"
            payload = payload._value
        if size <= 1:
            # one-element host values do value-guard: a scale or a step
            # counter baked into a lowering must change the key. A card
            # value is guarded by shape and dtype: reading it would stall
            # the stream, and a cache hit runs this call's lowerings
            got = _scalar_repr(payload)
            if got is not None:
                return f"<arr:{shape}:{v.dtype}:{got}>"
        # larger payloads guard shape/dtype only (cheap); value-captured
        # big arrays should be op INPUTS, not closure constants
        return f"<arr:{shape}:{v.dtype}>"
    if hasattr(v, "__code__") or isinstance(v, functools.partial):
        return fn_fingerprint(v, depth - 1)
    # plain object (callable objects like Layers too): guard its
    # primitive/scalar attributes one level deep (a GradScaler captured
    # through ``self``: its scale must key the cache)
    d = getattr(v, "__dict__", None)
    if d and depth > 0:
        guardable = [(k, x) for k, x in sorted(d.items())
                     if isinstance(x, _PRIM + (np.integer, np.floating,
                                               np.bool_))
                     or (hasattr(x, "shape") and hasattr(x, "dtype"))]
        attrs = ",".join(f"{k}:{_const_repr(x, 0)}"
                         for k, x in guardable[:16])
        return f"<{type(v).__name__}:{attrs}>"
    return f"<{type(v).__name__}>"


def fn_fingerprint(f, depth: int = 2) -> str:
    """Guard key covering the VALUES a lowering closed over, not just its
    attrs (reference: sot/symbolic/compile_cache.py object guards over
    globals/closure cells): a Python value baked into the closure (a
    scale, an epsilon) changes the key."""
    if isinstance(f, functools.partial):
        return ("partial(" + fn_fingerprint(f.func, depth) + ","
                + _const_repr(f.args, depth) + ","
                + _const_repr(f.keywords, depth) + ")")
    code = getattr(f, "__code__", None)
    if code is None:
        return f"<callable:{getattr(f, '__qualname__', type(f).__name__)}>"
    parts = [code.co_filename, str(code.co_firstlineno)]
    if depth > 0:
        for cell in getattr(f, "__closure__", None) or ():
            try:
                v = cell.cell_contents
            except ValueError:
                parts.append("<empty>")
                continue
            parts.append(_const_repr(v, depth))
        for d in getattr(f, "__defaults__", None) or ():
            parts.append(_const_repr(d, depth))
    return "|".join(parts)


def active() -> bool:
    return getattr(_tensor._capture, "sot", None) is not None


def current_segment() -> Optional["Segment"]:
    cap = getattr(_tensor._capture, "sot", None)
    return cap.segment if cap is not None else None


class suspended:
    """Step out of this thread's SOT capture for the block: a flush runs
    its segment's ops, and shape inference its lowerings, for real."""

    def __enter__(self):
        self._prev = getattr(_tensor._capture, "sot", None)
        _tensor._capture.sot = None
        return self

    def __exit__(self, *exc):
        _tensor._capture.sot = self._prev
        return False


# ----------------------------------------------------------- placeholders
def _concrete(x):
    if type(x) is LazyArray:
        return x.concrete()
    if isinstance(x, (tuple, list)):
        return type(x)(_concrete(v) for v in x)
    if isinstance(x, dict):
        return {k: _concrete(v) for k, v in x.items()}
    return x


class LazyArray:
    """Placeholder payload for a Tensor whose value is a pending segment
    node: the shape, dtype, device and ``requires_grad`` the op gives
    (``aval`` is a meta tensor). Anything else concretizes it, which
    flushes its segment: an unknown attribute, a torch function
    (``__torch_function__``), an operator, ``__array__``. The flush binds
    the value into every Tensor that holds the placeholder
    (``_owners``)."""

    __slots__ = ("segment", "node_id", "out_idx", "aval", "requires_grad",
                 "device", "_value", "_owners", "__weakref__")

    def __init__(self, segment, node_id, out_idx, aval, requires_grad,
                 device):
        self.segment = segment
        self.node_id = node_id
        self.out_idx = out_idx
        self.aval = aval
        self.requires_grad = requires_grad
        self.device = device
        self._value = None
        self._owners: list = []

    # ---- abstract metadata (Tensor.shape/.dtype/.stop_gradient read these)
    @property
    def shape(self):
        return self.aval.shape

    @property
    def dtype(self):
        return self.aval.dtype

    @property
    def ndim(self):
        return self.aval.dim()

    @property
    def is_leaf(self):
        # as torch's: a value with no grad_fn is a leaf
        return not self.requires_grad

    @property
    def is_cuda(self):
        return self.device.type == "cuda"

    @property
    def is_meta(self):
        return False

    @property
    def layout(self):
        return self.aval.layout

    def dim(self):
        return self.aval.dim()

    def size(self, *dim):
        return self.aval.size(*dim)

    def numel(self):
        return self.aval.numel()

    def stride(self, *dim):
        return self.aval.stride(*dim)

    def element_size(self):
        return self.aval.element_size()

    def is_floating_point(self):
        return self.aval.is_floating_point()

    def is_complex(self):
        return self.aval.is_complex()

    def _own(self, tensor) -> None:
        self._owners.append(weakref.ref(tensor))

    def detach(self):
        """A deferred ``detach`` while this value is pending in the
        current segment; the value's ``detach()`` otherwise."""
        seg = current_segment()
        if self._value is None and seg is self.segment:
            got = seg.add_with_structure("detach", torch.Tensor.detach,
                                         [self], {}, None, "detach")
            if got is not None:
                return got[0][0]
        return self.concrete().detach()

    # ---- concretization = graph break boundary
    def concrete(self) -> torch.Tensor:
        if self._value is None:
            self.segment.flush()
        if self._value is None:
            raise RuntimeError(
                "an SOT segment's flush did not give this value (the "
                "flush raised, or its capture ended with an error)")
        return self._value

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return getattr(self.concrete(), name)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return func(*_concrete(args), **_concrete(kwargs or {}))

    def __array__(self, dtype=None, copy=None):
        arr = self.concrete().detach().cpu().numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def __len__(self):
        return len(self.concrete())

    def __iter__(self):
        return iter(self.concrete())

    def __bool__(self):
        return bool(self.concrete())

    def __float__(self):
        return float(self.concrete())

    def __int__(self):
        return int(self.concrete())

    def __index__(self):
        return self.concrete().__index__()

    def __repr__(self):
        state = "pending" if self._value is None else "materialized"
        return (f"LazyArray(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"device={self.device}, {state})")


def _forward(name):
    def method(self, *args):
        return getattr(self.concrete(), name)(*_concrete(args))
    method.__name__ = name
    return method


for _name in ("add sub mul truediv floordiv mod pow matmul and or xor "
              "lshift rshift radd rsub rmul rtruediv rfloordiv rmod rpow "
              "rmatmul rand ror rxor eq ne lt le gt ge neg pos abs invert "
              "getitem setitem").split():
    setattr(LazyArray, f"__{_name}__", _forward(f"__{_name}__"))
LazyArray.__hash__ = object.__hash__
_tensor._LAZY = LazyArray


def _bind(lazy: LazyArray, value: torch.Tensor) -> None:
    """Materialize ``lazy``: its value, and the payload of every Tensor
    that still holds it."""
    lazy._value = value
    for ref in lazy._owners:
        t = ref()
        if t is not None and t._data is lazy:
            t._data = value
    lazy._owners = []


# ------------------------------------------------------- shape inference
_infer_cache: Dict[tuple, Optional[tuple]] = {}


def _meta_like(shape, stride, dtype, requires_grad):
    m = torch.empty_strided(tuple(shape), tuple(stride), dtype=dtype,
                            device="meta")
    if requires_grad:
        m.requires_grad_(True)
    return m


def _meta_of(a):
    if type(a) is LazyArray:
        return _meta_like(a.aval.shape, a.aval.stride(), a.aval.dtype,
                          a.requires_grad)
    return _meta_like(a.shape, a.stride(), a.dtype,
                      a.requires_grad and (a.is_floating_point()
                                           or a.is_complex()))


def _infer(op_name, fn, arrays, attrs, mask, key):
    """Output (aval, requires_grad) pairs and the multi-output flag of
    one op, from its lowering run on meta tensors under the current grad
    mode and amp state; None where it cannot run there (a data-dependent
    shape, a host read inside the lowering, an output that is no
    tensor). Cached by ``key``."""
    if key in _infer_cache:
        return _infer_cache[key]
    got = None
    try:
        metas = amp_cast(op_name, *[_meta_of(a) for a in arrays])
        if mask is not None:
            metas = [m.detach() if not keep else m
                     for m, keep in zip(metas, mask)]
        with suspended(), quiet_scope():
            out = fn(*metas, **attrs)
        multi = isinstance(out, (tuple, list))
        outs = list(out) if multi else [out]
        if outs and all(isinstance(o, torch.Tensor) and o.is_meta
                        for o in outs):
            got = (tuple((o.detach(), bool(o.requires_grad))
                         for o in outs), multi)
    except Exception:
        got = None
    if len(_infer_cache) >= _INFER_MAX:
        _infer_cache.pop(next(iter(_infer_cache)))
    _infer_cache[key] = got
    return got


# -------------------------------------------------------------- segments
class _Node(_Step):
    """One deferred op: a ``jit.program`` step (``fn`` with its attrs
    bound and the inputs ``differentiable_mask`` excludes detached; the
    amp state it was deferred under) over segment refs: ``("n", node,
    out)`` for this segment's values, ``("x", i)`` for its external
    payloads. ``grad`` is the grad mode it was deferred under (the replay
    runs it under that mode); ``key`` its part of the segment's cache
    key."""

    __slots__ = ("grad", "key")


def _payload_aval(a) -> tuple:
    return (tuple(a.shape), a.dtype, a.device)


class Segment:
    """One pre-break subgraph under construction (the StatementIR
    analogue)."""

    def __init__(self, owner: "capture"):
        self.owner = owner
        self.nodes: List[_Node] = []
        self.ext_arrays: List[torch.Tensor] = []
        self._ext_ids: dict = {}
        self._lazy: List[weakref.ref] = []
        self._flushed = False

    # ------------------------------------------------------------- inputs
    def _ext(self, arr) -> int:
        key = id(arr)
        idx = self._ext_ids.get(key)
        if idx is None:
            idx = len(self.ext_arrays)
            self.ext_arrays.append(arr)
            self._ext_ids[key] = idx
        return idx

    def _ref_of(self, a):
        if type(a) is LazyArray:
            if a._value is None and a.segment is self:
                return ("n", a.node_id, a.out_idx)
            return ("x", self._ext(a.concrete()))
        return ("x", self._ext(a))

    # ------------------------------------------------------------ capture
    def add_with_structure(self, op_name: str, fn: Callable, arrays: Sequence,
                           attrs: dict, mask, attr_key: str):
        """Append one op; returns (LazyArrays for its outputs, whether it
        gives several), or None where it cannot be shape-inferred."""
        grad = torch.is_grad_enabled()
        amp = amp_state()
        in_avals = tuple(
            (tuple(a.shape), a.dtype, bool(a.requires_grad))
            for a in arrays)
        inferred = _infer(op_name, fn, arrays, attrs, mask,
                          (op_name, attr_key, in_avals, grad, amp))
        if inferred is None:
            return None
        outs, multi = inferred
        in_refs = tuple(self._ref_of(a) for a in arrays)
        node_id = len(self.nodes)
        device = arrays[0].device
        node = _Node(op_name, _replayable(fn, attrs, mask), in_refs,
                     tuple(("n", node_id, k) for k in range(len(outs))),
                     dict(attrs), [a[0] for a in in_avals],
                     [tuple(o.shape) for o, _ in outs], amp, str(node_id))
        node.grad = grad
        node.key = (op_name, attr_key, amp, grad, in_refs, len(outs))
        self.nodes.append(node)
        lazies = [LazyArray(self, node_id, k, o, rg, device)
                  for k, (o, rg) in enumerate(outs)]
        self._lazy.extend(weakref.ref(l) for l in lazies)
        return lazies, multi

    # -------------------------------------------------------------- flush
    def fingerprint(self, out_refs) -> tuple:
        return (tuple(n.key for n in self.nodes),
                tuple(_payload_aval(a) for a in self.ext_arrays),
                tuple(out_refs))

    def flush(self) -> None:
        """Plan (on a cache miss) and run the accumulated ops, bind every
        live placeholder, and hand the capture a fresh segment."""
        if self._flushed:
            return
        self._flushed = True
        owner = self.owner
        owner._segment_closed(self)
        if not self.nodes:
            return
        live = [l for l in (r() for r in self._lazy)
                if l is not None and l._value is None]
        out_refs = sorted({(l.node_id, l.out_idx) for l in live})
        key = (owner.site_idx, self.fingerprint(out_refs))
        from ...compile import fusion as _fusion
        if _fusion.enabled():
            # fused and unfused plans of one segment never share an entry
            key = key + (_fusion.fingerprint(),)
        plan = owner.cache.get(key)
        if plan is not None:
            # LRU touch: FIFO eviction would throw out the steady-state
            # hot segment first
            owner.cache.pop(key)
            owner.cache[key] = plan
            if _metrics.enabled():
                _m_segment_cache.inc(event="hit")
            results = _run(plan, self.nodes, self.ext_arrays)
        else:
            if _metrics.enabled():
                _m_segment_cache.inc(event="miss")
            with _trace.span(f"sot_segment_compile:site{owner.site_idx}",
                             "compile", {"ops": len(self.nodes)}), \
                    _goodput.bill("compile"):
                c0 = time.perf_counter()
                steps = self.nodes
                if _fusion.enabled():
                    # the pass runs on a miss only: a hit replays the
                    # fused plan, and its counters stay per plan
                    fused, fstats = _fusion.fuse_sot_nodes(self.nodes,
                                                           out_refs)
                    if fused is not None:
                        steps = fused
                        owner.stats["fusion_rewritten"] = (
                            owner.stats.get("fusion_rewritten", 0)
                            + sum(fstats["rewritten"].values()))
                # the external payloads bind the program's inputs, the
                # values live at the flush are its outputs
                plan = Program(
                    list(steps),
                    {("x", i): i for i in range(len(self.ext_arrays))}, {},
                    (list, (("T",),) * len(out_refs)),
                    [("n", i, j) for i, j in out_refs])
                if len(owner.cache) >= SEGMENT_CACHE_MAX:
                    owner.cache.pop(next(iter(owner.cache)))
                owner.cache[key] = plan
                owner.stats["compiled"] += 1
                if _perf.capture_enabled():
                    # FLAGS_perf_capture: the plan's first run, analyzed
                    results, analysis = _perf.device.analyze_call(
                        _run, plan, self.nodes, self.ext_arrays)
                    _perf.record_compiled(
                        "sot", f"site{owner.site_idx}_ops{len(self.nodes)}",
                        analysis)
                else:
                    results = _run(plan, self.nodes, self.ext_arrays)
            if _metrics.enabled():
                _m_segment_compile_time.observe(time.perf_counter() - c0)
        value_of = dict(zip(out_refs, results))
        for l in live:
            _bind(l, value_of[(l.node_id, l.out_idx)])
        if owner.journal is not None:
            owner._journal_segment(self, key, out_refs, results)
        # the bound placeholders keep their segment: let go of its inputs
        self.ext_arrays, self._ext_ids, self._lazy = [], {}, []
        owner.stats["segments"] += 1
        owner.site_idx += 1


def _run(plan: Program, nodes: Sequence[_Node],
         ext: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Run a segment's plan on the external payloads ``ext``; returns the
    payloads of its outputs. Each deferred op runs as this call's node
    (its lowering closes over this call's values), a fused step as the
    plan holds it; each through ``dispatch.call`` (a fused step through
    its Paddle-API op) under the amp state and grad mode it was deferred
    under."""
    Tensor = _tensor.Tensor
    steps = [nodes[int(st.loc)] if type(st) is _Node else st
             for st in plan.steps]
    with suspended():
        outs = plan(*[Tensor(a) for a in ext], steps=steps)
    return [t._data for t in outs]


# --------------------------------------------------------------- journal
class FrameJournal:
    """Record of one SOT replay: the frame's segment graph and data flow.

    ``segments``: list of dicts with
      key        the segment's cache key
      nodes      the segment's ops (the bypass runs their lowerings)
      ext_srcs   per external payload: ("in", i) frame tensor input,
                 ("param", i) live parameter or buffer (re-read at bypass
                 time), ("seg", s, (node, out)) an earlier segment's
                 output, ("const", payload) a value the glue made
      out_refs   the (node, out) pairs the segment materialized
      guards     {(node, out): float} scalar values Python read at the
                 break (the bypass re-checks them; a change means the
                 glue's control flow could differ: fall back to replay)
    ``out_map``  the frame's return value as (structure, leaf
                 descriptors)
    ``eligible`` False where a bypass would be unsound for this frame
    """

    def __init__(self):
        self.segments: List[dict] = []
        self.out_map = None
        self.eligible = True
        self.reason = ""

    def mark_ineligible(self, why: str):
        self.eligible = False
        self.reason = why

    def structure_key(self):
        return tuple(s["key"] for s in self.segments)


class capture:
    """Context manager activating SOT lazy capture on this thread.

    ``cache`` persists across invocations (per StaticFunction and
    signature); ``stats`` counts segments flushed and plans made
    ("compiled") in this run. ``journal``: a FrameJournal, with the
    frame's input payloads and its parameters, records the segment graph
    for the steady-state bypass.
    """

    def __init__(self, cache: Optional[dict] = None,
                 journal: Optional[FrameJournal] = None,
                 input_arrays: Sequence = (), params: Sequence = ()):
        self.cache = cache if cache is not None else {}
        self.stats = {"segments": 0, "compiled": 0}
        self.segment = Segment(self)
        self.site_idx = 0
        self.journal = journal
        if journal is not None:
            self._src_of = {id(a): ("in", i)
                            for i, a in enumerate(input_arrays)}
            self._param_ids = {id(p._data): i for i, p in enumerate(params)}
            self._params = list(params)
            self._param_data0 = [p._data for p in params]
            self._out_values: dict = {}

    def _segment_closed(self, seg: Segment):
        if seg is self.segment:
            self.segment = Segment(self)

    def host_read(self, payload) -> None:
        """A graph break: the read of ``payload`` flushes its segment if
        it is pending; a break with no payload flushes the current
        segment."""
        if payload is None:
            self.segment.flush()
        elif type(payload) is LazyArray and payload._value is None:
            payload.segment.flush()

    # ------------------------------------------------- journal recording
    def _journal_segment(self, seg: Segment, key, out_refs, results):
        j = self.journal
        if not j.eligible:
            return
        srcs = []
        for a in seg.ext_arrays:
            src = self._src_of.get(id(a))
            if src is None:
                pi = self._param_ids.get(id(a))
                src = ("param", pi) if pi is not None else ("const", a)
            srcs.append(src)
        s_idx = len(j.segments)
        j.segments.append({"key": key, "nodes": seg.nodes, "ext_srcs": srcs,
                           "out_refs": list(out_refs), "guards": {}})
        for ref, val in zip(out_refs, results):
            # later segments that consume this output find it by id
            self._src_of[id(val)] = ("seg", s_idx, tuple(ref))
            self._out_values[(s_idx, tuple(ref))] = val

    def finalize_journal(self, leaves: Sequence, structure) -> None:
        """Classify the frame's return leaves (Tensors) and decide the
        break guards."""
        j = self.journal
        if j is None or not j.eligible:
            return
        # a parameter's payload swapped mid-frame: the glue has side
        # effects the bypass would not carry out
        for p, d0 in zip(self._params, self._param_data0):
            if p._data is not d0:
                j.mark_ineligible("parameter mutated during frame")
                return
        descrs = []
        for leaf in leaves:
            payload = leaf._data
            if type(payload) is LazyArray:
                payload = payload.concrete()
            if payload.grad_fn is not None:
                j.mark_ineligible("output carries autograd state")
                return
            wrap = bool(leaf.stop_gradient)
            src = self._src_of.get(id(payload))
            if src is None:
                descrs.append(("const", payload, wrap))
            elif src[0] == "seg":
                descrs.append(("seg", src[1], src[2], wrap))
            else:
                descrs.append((src[0], src[1], wrap))
        j.out_map = (structure, descrs)
        # break guards: outputs of segments that the glue read (not an
        # input of a later segment, not returned). Scalars are
        # value-guarded; a larger glue read cannot be, so the frame stays
        # on Python replay
        consumed = set()
        for srec in j.segments:
            for src in srec["ext_srcs"]:
                if src[0] == "seg":
                    consumed.add((src[1], tuple(src[2])))
        returned = {(d[1], tuple(d[2])) for d in descrs if d[0] == "seg"}
        # EVERY segment's glue reads need guards, the last one's too: a
        # frame can break, read a scalar, branch on it, and return
        for s_idx, srec in enumerate(j.segments):
            for ref in srec["out_refs"]:
                r = (s_idx, tuple(ref))
                if r in consumed or r in returned:
                    continue
                val = self._out_values.get(r)
                if val is None:
                    continue
                if val.numel() != 1:
                    j.mark_ineligible(
                        "non-scalar break value read by glue code")
                    return
                srec["guards"][tuple(ref)] = float(val.detach().reshape(
                    ()).item())

    def __enter__(self):
        if getattr(_tensor._capture, "sot", None) is not None:
            raise RuntimeError("SOT capture is not reentrant")
        _tensor._capture.sot = self
        _tensor._sot_seen = True
        return self

    def __exit__(self, exc_type, exc, tb):
        _tensor._capture.sot = None
        if exc_type is None:
            self.segment.flush()
        return False


def replay_frame(journal: FrameJournal, cache: dict, input_arrays: Sequence,
                 params: Sequence):
    """Steady-state fast path: run the journal's stitched segments
    directly (no Python frame, no deferral, no fingerprints). Returns
    (ok, (structure, [(payload, stop_gradient)]), why); ``ok=False``
    means a guard missed or state moved, and the caller falls back to a
    recording Python replay."""
    env: dict = {}
    for s_idx, srec in enumerate(journal.segments):
        plan = cache.get(srec["key"])
        if plan is None:
            return False, None, "segment plan evicted"
        ext = []
        for src in srec["ext_srcs"]:
            kind = src[0]
            if kind == "in":
                ext.append(input_arrays[src[1]])
            elif kind == "param":
                if src[1] >= len(params):
                    return False, None, "parameter list changed"
                ext.append(params[src[1]]._data)
            elif kind == "seg":
                ext.append(env[(src[1], tuple(src[2]))])
            else:
                ext.append(src[1])
        results = _run(plan, srec["nodes"], ext)
        for ref, val in zip(srec["out_refs"], results):
            env[(s_idx, tuple(ref))] = val
        for ref, expected in srec["guards"].items():
            got = float(env[(s_idx, tuple(ref))].detach().reshape(()).item())
            if got != expected:
                # the scalar Python branched on changed: the glue's
                # control flow could differ, so replay honestly
                return False, None, "break value guard miss"
    structure, descrs = journal.out_map
    leaves = []
    for d in descrs:
        kind = d[0]
        if kind == "seg":
            leaves.append((env[(d[1], tuple(d[2]))], d[3]))
        elif kind == "in":
            leaves.append((input_arrays[d[1]], d[2]))
        elif kind == "param":
            if d[1] >= len(params):
                return False, None, "parameter list changed"
            leaves.append((params[d[1]]._data, d[2]))
        else:
            leaves.append((d[1], d[2]))
    return True, (structure, leaves), ""


def record_or_none(op_name: str, fn: Callable, tensor_inputs: Sequence,
                   attrs: dict, mask=None):
    """Dispatch hook: append the op to the active segment. Returns
    ``(lazy_outputs, is_multi_output)``, or None when SOT is inactive or
    the op cannot be deferred: no tensor input, or no shape inference (a
    data-dependent output shape such as ``nonzero``'s); the segment is
    then flushed and the caller runs the op on the values, an implicit
    break."""
    seg = current_segment()
    if seg is None or not tensor_inputs:
        return None
    arrays = [t._data for t in tensor_inputs]
    # value-guard the lowering's closure: constants captured outside the
    # attrs dict must change the key when they change
    attr_key = (_const_repr(attrs, 2) + "#" + fn_fingerprint(fn)
                + ("" if mask is None else "#" + repr(tuple(mask))))
    got = seg.add_with_structure(op_name, fn, arrays, attrs, mask, attr_key)
    if got is None:
        seg.flush()
    return got
