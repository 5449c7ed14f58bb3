"""The fusion pass over a ``torch.fx`` graph: ``jit.to_static``'s adapter
(counterpart of ``trace_rewrite``/``rewrite_traced`` in
``paddle_tpu/compile/fusion/__init__.py``).

``trace_program`` traces a callable with ``torch.fx`` and, with fusion on,
runs the pass:

1. The tracer traces *into* every module (the port's ``Linear`` and
   ``LayerNorm`` become ``F.linear`` and ``F.layer_norm`` calls with their
   parameters as inputs) and keeps whole the port's functionals that
   launch kernels, draw random numbers, cast for amp or are one op to the
   pass (``_leaves``: linear, matmul, attention, the losses, dropout, the
   norms, softmax, swiglu, rotary embedding, the fused ops). Each leaf
   node runs under the amp state it was traced under (recorded in
   ``node.meta["amp"]``), so amp's casts happen inside the leaves and the
   records hold no cast: the chains match as they do without amp.
   A block under ``remat_block`` (recompute) becomes a region: its own
   graph, traced, shape-propagated and fused apart, which the outer graph
   calls under ``fleet.recompute``; no chain crosses a region's edge.
2. ``ShapeProp`` on the example inputs gives every node its shape.
3. Each node that computes a tensor becomes a record with the JAX
   package's op name and attributes (``linear``, ``layer_norm``,
   ``rms_norm``, ``gelu``, ``silu``, ``relu``, ``add``, ``reshape``,
   ``rotary_embedding``); shape queries are not records, as shapes are
   static in a JAX trace.
4. ``fuse_steps`` plans the rewrite; each fused step becomes one call to
   the port's ``F.fused_*`` inserted before the chain's first node, its
   outputs take over the chain's, and dead code is removed.

The trace is specialized on the arguments that are not tensors (they are
part of ``to_static``'s cache key, as is the amp state). While tracing,
the leaves are swapped into the namespaces that call them and restored
afterwards.
"""
from __future__ import annotations

import functools
import inspect
import operator
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import fx, nn
from torch.fx.passes.shape_prop import ShapeProp, TensorMetadata
from torch.nn import functional as TF

from ...amp.state import AmpState, amp_state, amp_state_as
from . import fuse_steps


def _leaves() -> tuple:
    """The port functionals the tracer keeps as single calls."""
    from ...models.llama import rotary_embedding
    from ...nn import functional as F
    return (F.linear, F.matmul, F.flash_attention,
            F.scaled_dot_product_attention, F.block_multihead_attention,
            F.cross_entropy, F.fused_linear_cross_entropy, F.dropout,
            F.layer_norm, F.rms_norm, F.softmax, F.swiglu, rotary_embedding,
            F.fused_bias_act, F.fused_residual_norm, F.fused_norm_linear,
            F.fused_rope_proj)


def _tracer_of(args, kwargs):
    found = []
    fx.node.map_aggregate((args, kwargs), lambda a: found.append(a)
                          if isinstance(a, fx.Proxy) else None)
    return found[0].tracer if found else None


def _bound(fn, amp: AmpState, fixed: Optional[dict] = None):
    """``fn`` run under the amp state ``amp`` with the keyword arguments
    ``fixed`` added; ``.leaf`` is ``fn``."""
    fixed = fixed or {}

    def target(*a, **kw):
        with amp_state_as(amp):
            return fn(*a, **kw, **fixed)
    functools.update_wrapper(target, fn)
    target.leaf = fn
    return target


def _as_leaf(fn):
    """``fn`` that records one ``call_function`` node when it meets a proxy
    and runs as itself otherwise. The node's target runs under the amp
    state of the trace at that point; a ``torch.Generator`` argument is
    bound into it, as a graph cannot hold one."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        tracer = _tracer_of(args, kwargs)
        if tracer is None:
            return fn(*args, **kwargs)
        fixed = {k: v for k, v in kwargs.items()
                 if isinstance(v, torch.Generator)}
        kwargs = {k: v for k, v in kwargs.items() if k not in fixed}
        amp = amp_state()
        proxy = tracer.create_proxy("call_function", _bound(fn, amp, fixed),
                                    args, kwargs)
        proxy.node.meta["amp"] = amp
        return proxy
    return call


class _Region:
    """A block that the model checkpoints (``remat_block``): its own graph
    module, called under ``fleet.recompute`` with the block's generators
    while grad is enabled. With ``propagate`` set, a call runs
    ``ShapeProp`` over its graph instead, for the fusion pass. The block
    is traced once the trace that met it has ended (``trace``): fx's
    tracers do not nest."""

    def __init__(self, blk: nn.Module):
        from ...distributed.fleet.recompute.recompute import \
            _discover_generators
        self.blk = blk
        self.generators = _discover_generators(blk)
        self.gm: Optional[fx.GraphModule] = None
        self.regions: List["_Region"] = []
        self.propagate = False

    def trace(self) -> List["_Region"]:
        """Trace the block; returns this region and every region within
        it, traced."""
        tracer = _Tracer(_leaves())
        # the checkpointed call passes the block's tensors only: arguments
        # with defaults (LLaMA's decode cache and position) keep them
        params = inspect.signature(self.blk.forward).parameters.values()
        defaults = {p.name: p.default for p in params
                    if p.default is not inspect.Parameter.empty}
        self.gm = fx.GraphModule(self.blk,
                                 tracer.trace(self.blk, defaults or None))
        self.regions = tracer.regions
        return [self] + [r for inner in self.regions for r in inner.trace()]

    def __call__(self, *args):
        if self.propagate:
            return ShapeProp(self.gm).propagate(*args)
        if not torch.is_grad_enabled():
            return self.gm(*args)
        from ...distributed.fleet.recompute import recompute
        return recompute(self.gm, *args, generators=self.generators)


def _as_region(fn):
    """``remat_block`` that, when it meets a proxy, traces the block into
    a ``_Region`` and records one call of it."""
    @functools.wraps(fn)
    def call(blk, *args):
        tracer = _tracer_of(args, {})
        if tracer is None:
            return fn(blk, *args)
        region = _Region(blk)
        tracer.regions.append(region)

        def recompute_block(*xs):
            return region(*xs)
        recompute_block.region = region
        return tracer.create_proxy("call_function", recompute_block, args,
                                   {})
    return call


class _Tracer(fx.Tracer):
    def __init__(self, leaf_fns: Sequence):
        super().__init__()
        from ...models._remat import remat_block
        self._wrap = {id(f): _as_leaf for f in leaf_fns}
        self._wrap[id(remat_block)] = _as_region
        self._saved: List[Tuple[dict, str, object]] = []
        self._patched: set = set()
        #: the checkpointed blocks met, in order
        self.regions: List[_Region] = []

    def is_leaf_module(self, m: nn.Module, qualname: str) -> bool:
        return False

    def _patch(self, namespace: dict) -> None:
        if id(namespace) in self._patched:
            return
        self._patched.add(id(namespace))
        for key, value in list(namespace.items()):
            wrap = self._wrap.get(id(value))
            if wrap is not None:
                self._saved.append((namespace, key, value))
                namespace[key] = wrap(value)

    def call_module(self, m, forward, args, kwargs):
        # every module is traced through, also one a plain function closes
        # over (not a submodule of the root)
        self._patch(getattr(type(m).forward, "__globals__", {}))
        return forward(*args, **kwargs)

    def create_arg(self, a):
        # a parameter the root does not own (a plain function closing over
        # a layer) becomes an attribute of the traced module
        if isinstance(a, nn.Parameter) and not any(
                a is p for p in self.root.parameters()):
            i = 0
            while hasattr(self.root, f"_param_constant{i}"):
                i += 1
            setattr(self.root, f"_param_constant{i}", a)
            return self.create_node("get_attr", f"_param_constant{i}", (),
                                    {})
        return super().create_arg(a)

    def trace(self, root, concrete_args=None):
        try:
            for name, mod in list(sys.modules.items()):
                if mod is not None and name.split(".")[0] == "paddle_tpu_torch":
                    self._patch(vars(mod))
            fn = root.forward if isinstance(root, nn.Module) else root
            self._patch(getattr(fn, "__globals__", {}))
            return super().trace(root, concrete_args)
        finally:
            for namespace, key, value in reversed(self._saved):
                namespace[key] = value
            self._saved.clear()
            self._patched.clear()


# ------------------------------------------------------------- records
class _Record:
    """One traced node as the pass sees it; value ids are fx nodes."""

    __slots__ = ("name", "in_ids", "out_ids", "attrs", "in_shapes",
                 "out_shapes", "loc", "amp")

    def __init__(self, name, in_ids, out_ids, attrs, in_shapes, out_shapes,
                 loc, amp):
        self.name = name
        self.in_ids, self.out_ids = tuple(in_ids), tuple(out_ids)
        self.attrs = attrs
        self.in_shapes, self.out_shapes = tuple(in_shapes), tuple(out_shapes)
        self.loc = loc
        self.amp = amp


def _meta(node) -> Optional[object]:
    return node.meta.get("tensor_meta") if isinstance(node, fx.Node) else None


def _shape(node) -> tuple:
    meta = _meta(node)
    return tuple(meta.shape) if isinstance(meta, TensorMetadata) else ()


def _is_node(a) -> bool:
    return isinstance(a, fx.Node)


def _classify(node, port) -> Tuple[str, dict, list]:
    """(record name, attrs, tensor inputs in order) of a call node."""
    t, args, kwargs = getattr(node.target, "leaf", node.target), node.args, \
        node.kwargs

    def arg(i, name, default=None):
        return args[i] if len(args) > i else kwargs.get(name, default)

    if node.op == "call_function":
        if t is TF.linear or t is port["linear"]:
            bias = arg(2, "bias")
            return "linear", {}, [
                arg(0, "input" if t is TF.linear else "x"),
                arg(1, "weight")] + ([bias] if _is_node(bias) else [])
        if t is TF.layer_norm or t is port["layer_norm"]:
            shape = arg(1, "normalized_shape")
            w, b = arg(2, "weight"), arg(3, "bias")
            eps = arg(4, "eps" if t is TF.layer_norm else "epsilon", 1e-5)
            return "layer_norm", {
                "epsilon": float(eps),
                "norm_ndim": 1 if isinstance(shape, int) else len(shape),
                "has_w": _is_node(w), "has_b": _is_node(b)}, [
                arg(0, "input" if t is TF.layer_norm else "x"),
                *[a for a in (w, b) if _is_node(a)]]
        if t is port["rms_norm"]:
            x, w, b = arg(0, "x"), arg(1, "weight"), arg(2, "bias")
            ndim = len(_shape(x))
            axis = arg(4, "begin_norm_axis", -1) % max(ndim, 1)
            return "rms_norm", {
                "epsilon": float(arg(3, "epsilon", 1e-6)),
                "norm_ndim": ndim - axis, "has_w": _is_node(w),
                "has_b": _is_node(b)}, [x, *[a for a in (w, b)
                                             if _is_node(a)]]
        if t is TF.gelu:
            return "gelu", {"approximate":
                            arg(1, "approximate", "none") == "tanh"}, [args[0]]
        if t is TF.silu:
            return "silu", {}, [args[0]]
        if t in (TF.relu, torch.relu):
            return "relu", {}, [args[0]]
        if t in (operator.add, torch.add) and "alpha" not in kwargs:
            return "add", {}, [a for a in args[:2] if _is_node(a)]
        if t is torch.reshape:
            return "reshape", {}, [args[0]]
        if t is port["rotary_embedding"]:
            off = arg(2, "pos_offset", 0)
            attrs = ({"theta": float(arg(1, "theta", 10000.0)),
                      "pos_offset": off}
                     if isinstance(off, int) and not isinstance(off, bool)
                     else {})
            return "rotary_embedding", attrs, [args[0]]
    elif node.op == "call_method":
        if t == "add" and len(args) == 2 and "alpha" not in kwargs:
            return "add", {}, [a for a in args if _is_node(a)]
        if t in ("reshape", "view"):
            return "reshape", {}, [args[0]]
        if t == "relu":
            return "relu", {}, [args[0]]
    name = t if isinstance(t, str) else getattr(t, "__name__", str(t))
    return name, {}, [a for a in node.all_input_nodes
                      if _meta(a) is not None]


def _records(graph: fx.Graph) -> Tuple[list, set]:
    """The pass's records of a shape-propagated graph, and the returned
    values (the external set)."""
    from ...models.llama import rotary_embedding
    from ...nn.functional import layer_norm, linear, rms_norm
    port = {"linear": linear, "layer_norm": layer_norm, "rms_norm": rms_norm,
            "rotary_embedding": rotary_embedding}
    steps, external = [], set()
    for node in graph.nodes:
        if node.op == "output":
            fx.node.map_arg(node.args, lambda n: external.add(n))
            continue
        if node.op not in ("call_function", "call_method") \
                or _meta(node) is None:
            continue            # inputs, parameters, shape arithmetic
        name, attrs, ins = _classify(node, port)
        steps.append(_Record(name, ins, (node,), attrs,
                             [_shape(a) for a in ins], [_shape(node)],
                             node.name, node.meta.get("amp")))
    return steps, external


def _rewrite(gm: fx.GraphModule, plan: list) -> None:
    graph = gm.graph
    # parameters are read where first used; a fused call before that point
    # (the norm weight of a residual_norm, read after the add) needs them
    # earlier, so every get_attr moves up to the inputs
    params = [n for n in graph.nodes if n.op == "get_attr"]
    first = next(n for n in graph.nodes
                 if n.op not in ("placeholder", "get_attr"))
    for n in params:
        first.prepend(n)
    by_name = {n.name: n for n in graph.nodes}
    current: Dict[fx.Node, fx.Node] = {}
    for st in plan:
        if not getattr(st, "pattern", ""):
            continue
        args, kwargs = st.fn.bind([current.get(v, v) for v in st.in_ids])
        target = st.fn.fn if st.amp is None else _bound(st.fn.fn, st.amp)
        with graph.inserting_before(by_name[st.loc]):
            new = graph.call_function(target, args, kwargs)
            outs = [new] if len(st.out_ids) == 1 else [
                graph.call_function(operator.getitem, (new, k))
                for k in range(len(st.out_ids))]
        for old, rep in zip(st.out_ids, outs):
            old.replace_all_uses_with(rep)
            current[old] = rep
    graph.eliminate_dead_code()
    graph.lint()
    gm.recompile()


def trace_program(fn, args: Sequence, concrete: Dict, fuse: bool
                  ) -> Tuple[fx.GraphModule, Optional[dict]]:
    """Trace ``fn`` (a module or a function) specialized on ``concrete``
    (its non-tensor arguments, by name); with ``fuse``, run the fusion
    pass over the trace on ``args`` (every argument, in signature order).
    Returns the graph module, called with ``args``, and the pass's stats
    (None without ``fuse``)."""
    tracer = _Tracer(_leaves())
    graph = tracer.trace(fn, concrete_args=dict(concrete) or None)
    gm = fx.GraphModule(fn if isinstance(fn, nn.Module) else tracer.root,
                        graph)
    regions = [r for region in tracer.regions for r in region.trace()]
    if not fuse:
        return gm, None
    for region in regions:
        region.propagate = True
    try:
        with torch.no_grad():
            ShapeProp(gm).propagate(*args)
    finally:
        for region in regions:
            region.propagate = False
    stats = _fuse(gm)
    for region in regions:
        _add_stats(stats, _fuse(region.gm))
    return gm, stats


def _fuse(gm: fx.GraphModule) -> dict:
    """Run the pass over one shape-propagated graph and rewrite it."""
    steps, external = _records(gm.graph)
    plan, stats = fuse_steps(steps, external)
    if stats["rewritten"]:
        _rewrite(gm, plan)
    return stats


def _add_stats(total: dict, more: dict) -> None:
    """Fold a region's pass stats into the program's."""
    for key, value in more.items():
        if isinstance(value, dict):
            for name, n in value.items():
                total[key][name] = total[key].get(name, 0) + n
        else:
            total[key] += value
