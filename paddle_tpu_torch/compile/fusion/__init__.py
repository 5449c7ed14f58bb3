"""Graph-fusion pass over op-list records (counterpart of
``paddle_tpu/compile/fusion/__init__.py``; the port keeps its own copy of
the framework-neutral core).

``fuse_steps`` matches chains in any op list whose records carry
``name/fn/in_ids/out_ids/attrs/in_shapes/out_shapes`` and plans their
rewrite onto the fused ops of ``nn/functional/fused.py``. Two adapters
feed it, and ``jit.to_static`` runs both:

* ``compile/fusion/fx.py``: a ``torch.fx`` graph of a ``torch.nn.Module``
  or a function on ``torch.Tensor``s, rewritten from the plan;
* ``rewrite_program`` / ``rewrite_traced`` here: the op stream the
  dispatcher's recorder took from a Paddle-API callable
  (``jit/program.py``). The plan replaces the program's steps, so a
  replay runs the fused program only; the JAX package's ``apply`` runs
  the unfused chain and then the fused one, and leaves XLA to drop the
  dead values, which eager torch would compute;
* ``fuse_program_ops`` here: a ``static.Program``'s steps, the fetched
  values as the external set; ``Executor.run`` replays the plan;
* ``fuse_sot_nodes`` here: an SOT segment's deferred ops (``jit/sot``),
  the values live at its flush as the external set.

Patterns:

=================  ======================================================
``norm_linear``    layer_norm/rms_norm -> linear[-> gelu/silu/relu] (one
                   GEMM with a norm prologue and a bias/act epilogue)
``linear_act``     linear -> gelu/silu/relu        (norm-less variant)
``residual_norm``  add(x, y) -> layer_norm/rms_norm (the sum stays a REAL
                   output, so external residual-stream uses are legal)
``bias_act``       add(x, bias-vector) -> gelu/silu/relu
``rope_proj``      linear -> reshape(B,S,H,D) -> rotary_embedding
=================  ======================================================

Rejection rule: an *interior* value (consumed by the fused op and not
re-emitted as one of its outputs) that is externally visible (returned, or
read by any step outside the chain) rejects the match, and so does an
input that is produced after the chain's first step (each counted in
``paddle_tpu_fusion_{matched,rewritten,rejected}_total{pattern=}``, the
JAX package's counters, and in ``stats``).

Everything is gated by ``FLAGS_enable_fusion`` (default off).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ...core import flags
from ...observability import metrics as _metrics

__all__ = ["enabled", "fingerprint", "fuse_steps", "FusedStep", "PATTERNS",
           "FUSION_VERSION", "rewrite_program", "rewrite_traced",
           "fuse_program_ops", "fuse_sot_nodes"]

#: bump when the pattern set or a fused rewrite's semantics change
FUSION_VERSION = 1

PATTERNS = ("norm_linear", "linear_act", "residual_norm", "bias_act",
            "rope_proj")

_NORM_OPS = ("layer_norm", "rms_norm")
_ACT_OPS = ("gelu", "silu", "relu")

_m_matched = _metrics.counter(
    "paddle_tpu_fusion_matched_total",
    "Fusion-pattern candidates that matched structurally (rewritten + "
    "rejected).", labelnames=("pattern",))
_m_rewritten = _metrics.counter(
    "paddle_tpu_fusion_rewritten_total",
    "Fusion-pattern candidates rewritten onto fused ops.",
    labelnames=("pattern",))
_m_rejected = _metrics.counter(
    "paddle_tpu_fusion_rejected_total",
    "Fusion-pattern candidates rejected (interior value externally "
    "visible, multi-consumer interior, or producer-order hazard).",
    labelnames=("pattern",))


def enabled() -> bool:
    return bool(flags.get_flag("enable_fusion"))


def fingerprint() -> str:
    """The rewrite the pass would apply, as a key component: traces of a
    program with fusion on and off never share a cache entry."""
    return f"fusion/v{FUSION_VERSION}[{','.join(PATTERNS)}]"


@dataclass
class FusedStep:
    """One rewritten subgraph, replayable like a record."""

    name: str
    fn: Callable
    in_ids: tuple
    out_ids: tuple
    attrs: dict = field(default_factory=dict)
    in_shapes: tuple = ()
    out_shapes: tuple = ()
    pattern: str = ""
    #: the amp state the anchor record was traced under (``amp_state()``);
    #: the fused op runs under it, as the chain's first op would have
    amp: Optional[tuple] = None
    #: provenance of the anchor record (the chain's first step)
    loc: str = ""
    #: the grad mode an SOT segment deferred the anchor record under (the
    #: fused op runs under it); None elsewhere: the replay's own
    grad: Optional[bool] = None


def _act_name(step) -> Optional[str]:
    """Map a matched activation step to the fused epilogue vocabulary."""
    if step.name == "gelu":
        return "gelu_tanh" if (step.attrs or {}).get("approximate") \
            else "gelu"
    if step.name in ("silu", "relu"):
        return step.name
    return None


class _Graph:
    """Def/use index over the step list."""

    def __init__(self, steps, external_ids):
        self.steps = list(steps)
        self.external = set(external_ids)
        self.producer: Dict = {}
        self.uses: Dict = {}
        for i, st in enumerate(self.steps):
            for o in st.out_ids:
                self.producer[o] = i
            for v in st.in_ids:
                self.uses.setdefault(v, []).append(i)

    def sole_consumer(self, vid) -> Optional[int]:
        u = self.uses.get(vid, [])
        return u[0] if len(u) == 1 else None

    def interior_ok(self, vid, consumer_idx) -> bool:
        """vid may be swallowed: exactly one consumer and not external."""
        return (self.sole_consumer(vid) == consumer_idx
                and vid not in self.external)

    def inputs_available(self, in_ids, first_idx) -> bool:
        """Every fused-step input must exist before the fused step's
        position (graph inputs always do; produced values must come from
        earlier steps)."""
        return all(self.producer.get(v, -1) < first_idx for v in in_ids)


# --------------------------------------------------------------------------
# Pattern matchers: (graph, i) -> (match | None, rejected: bool)
# match = (pattern, consumed_indices, FusedStep)
# --------------------------------------------------------------------------
def _lazy_fused():
    from ...nn.functional import fused as FF
    return FF


def _match_norm_linear(g: _Graph, i: int):
    st = g.steps[i]
    if st.name not in _NORM_OPS:
        return None, False
    attrs = st.attrs or {}
    if attrs.get("norm_ndim") != 1 or "epsilon" not in attrs:
        return None, False          # multi-dim norm
    y = st.out_ids[0]
    consumers = g.uses.get(y, [])
    lin_idx = next((j for j in consumers if g.steps[j].name == "linear"
                    and g.steps[j].in_ids
                    and g.steps[j].in_ids[0] == y), None)
    if lin_idx is None:
        return None, False
    # structural candidate exists from here on
    if not g.interior_ok(y, lin_idx):
        return "rejected", True
    lin = g.steps[lin_idx]
    has_bias = len(lin.in_ids) == 3
    consumed = [i, lin_idx]
    act = ""
    out_step = lin
    lin_out = lin.out_ids[0]
    act_idx = g.sole_consumer(lin_out)
    if (act_idx is not None and g.steps[act_idx].name in _ACT_OPS
            and lin_out not in g.external):
        a = _act_name(g.steps[act_idx])
        if a is not None:
            act = a
            consumed.append(act_idx)
            out_step = g.steps[act_idx]
    has_w = bool(attrs.get("has_w", len(st.in_ids) >= 2))
    has_b = bool(attrs.get("has_b", len(st.in_ids) >= 3))
    nw = st.in_ids[1] if has_w else None
    nb = st.in_ids[1 + has_w] if has_b else None
    in_ids = [st.in_ids[0], lin.in_ids[1]]
    in_shapes = [st.in_shapes[0], lin.in_shapes[1]]
    if has_bias:
        in_ids.append(lin.in_ids[2])
        in_shapes.append(lin.in_shapes[2])
    if nw is not None:
        in_ids.append(nw)
        in_shapes.append(st.in_shapes[1])
    if nb is not None:
        in_ids.append(nb)
        in_shapes.append(st.in_shapes[1 + has_w])
    if not g.inputs_available(in_ids, i):
        return "rejected", True
    FF = _lazy_fused()
    fused = FusedStep(
        name="fused_norm_linear",
        fn=FF.norm_linear_lowering(st.name, float(attrs["epsilon"]),
                                   act, has_bias, has_w, has_b),
        in_ids=tuple(in_ids), out_ids=tuple(out_step.out_ids),
        attrs={"norm_type": st.name, "epsilon": float(attrs["epsilon"]),
               "activation": act},
        in_shapes=tuple(in_shapes), out_shapes=tuple(out_step.out_shapes),
        pattern="norm_linear")
    return ("norm_linear", consumed, fused), False


def _match_linear_act(g: _Graph, i: int):
    st = g.steps[i]
    if st.name != "linear" or not st.out_ids:
        return None, False
    lin_out = st.out_ids[0]
    act_idx = g.sole_consumer(lin_out)
    consumers = g.uses.get(lin_out, [])
    has_act_consumer = any(g.steps[j].name in _ACT_OPS
                           and _act_name(g.steps[j]) is not None
                           for j in consumers)
    if not has_act_consumer:
        return None, False
    if act_idx is None or lin_out in g.external:
        return "rejected", True
    act = _act_name(g.steps[act_idx])
    if act is None:
        return None, False
    has_bias = len(st.in_ids) == 3
    if not g.inputs_available(st.in_ids, i):
        return "rejected", True
    FF = _lazy_fused()
    fused = FusedStep(
        name="fused_norm_linear",
        fn=FF.norm_linear_lowering("", 0.0, act, has_bias, False, False),
        in_ids=tuple(st.in_ids), out_ids=tuple(g.steps[act_idx].out_ids),
        attrs={"norm_type": "", "activation": act},
        in_shapes=tuple(st.in_shapes),
        out_shapes=tuple(g.steps[act_idx].out_shapes),
        pattern="linear_act")
    return ("linear_act", [i, act_idx], fused), False


def _match_residual_norm(g: _Graph, i: int):
    st = g.steps[i]
    if st.name != "add" or len(st.in_ids) != 2 or not st.out_ids:
        return None, False
    if (len(st.in_shapes) != 2 or st.in_shapes[0] != st.in_shapes[1]
            or len(st.in_shapes[0]) < 2
            or st.in_shapes[0] != st.out_shapes[0]):
        return None, False           # not a same-shape residual add
    s_out = st.out_ids[0]
    norm_idx = next(
        (j for j in g.uses.get(s_out, [])
         if g.steps[j].name in _NORM_OPS
         and (g.steps[j].attrs or {}).get("norm_ndim") == 1
         and "epsilon" in (g.steps[j].attrs or {})
         and g.steps[j].in_ids and g.steps[j].in_ids[0] == s_out), None)
    if norm_idx is None:
        return None, False
    norm = g.steps[norm_idx]
    attrs = norm.attrs or {}
    has_w = bool(attrs.get("has_w", len(norm.in_ids) >= 2))
    has_b = bool(attrs.get("has_b", len(norm.in_ids) >= 3))
    in_ids = list(st.in_ids) + list(norm.in_ids[1:])
    in_shapes = list(st.in_shapes) + list(norm.in_shapes[1:])
    if not g.inputs_available(in_ids, i):
        return "rejected", True
    # the sum is RE-EMITTED as the fused op's second output, so other
    # consumers / external visibility of it are legal
    FF = _lazy_fused()
    fused = FusedStep(
        name="fused_residual_norm",
        fn=FF.residual_norm_lowering(norm.name, float(attrs["epsilon"]),
                                     has_w, has_b),
        in_ids=tuple(in_ids),
        out_ids=(norm.out_ids[0], s_out),
        attrs={"norm_type": norm.name,
               "epsilon": float(attrs["epsilon"])},
        in_shapes=tuple(in_shapes),
        out_shapes=(norm.out_shapes[0], st.out_shapes[0]),
        pattern="residual_norm")
    return ("residual_norm", [i, norm_idx], fused), False


def _match_bias_act(g: _Graph, i: int):
    st = g.steps[i]
    if st.name != "add" or len(st.in_ids) != 2 or not st.out_ids:
        return None, False
    shapes = list(st.in_shapes) if len(st.in_shapes) == 2 else None
    if shapes is None:
        return None, False
    out_shape = st.out_shapes[0] if st.out_shapes else ()
    bias_side = None
    for side in (1, 0):
        other = 1 - side
        if (len(shapes[side]) == 1 and len(shapes[other]) >= 2
                and len(out_shape) >= 1
                and int(shapes[side][0]) == int(out_shape[-1])):
            bias_side = side
            break
    if bias_side is None:
        return None, False
    add_out = st.out_ids[0]
    consumers = g.uses.get(add_out, [])
    if not any(g.steps[j].name in _ACT_OPS
               and _act_name(g.steps[j]) is not None
               for j in consumers):
        return None, False
    act_idx = g.sole_consumer(add_out)
    if act_idx is None or add_out in g.external:
        return "rejected", True
    act = _act_name(g.steps[act_idx])
    if act is None:
        return None, False
    x_side = 1 - bias_side
    in_ids = (st.in_ids[x_side], st.in_ids[bias_side])
    if not g.inputs_available(in_ids, i):
        return "rejected", True
    FF = _lazy_fused()
    fused = FusedStep(
        name="fused_bias_act",
        fn=FF.bias_act_lowering(act),
        in_ids=in_ids, out_ids=tuple(g.steps[act_idx].out_ids),
        attrs={"activation": act},
        in_shapes=(st.in_shapes[x_side], st.in_shapes[bias_side]),
        out_shapes=tuple(g.steps[act_idx].out_shapes),
        pattern="bias_act")
    return ("bias_act", [i, act_idx], fused), False


def _match_rope_proj(g: _Graph, i: int):
    st = g.steps[i]
    if st.name != "linear" or not st.out_ids:
        return None, False
    if len(st.in_shapes) < 2 or len(st.in_shapes[0]) != 3:
        return None, False
    lin_out = st.out_ids[0]
    rs_idx = g.sole_consumer(lin_out)
    if rs_idx is None or g.steps[rs_idx].name != "reshape":
        return None, False
    rs = g.steps[rs_idx]
    if not rs.out_shapes or len(rs.out_shapes[0]) != 4:
        return None, False
    b, s, h, d = (int(v) for v in rs.out_shapes[0])
    if (b, s) != tuple(int(v) for v in st.in_shapes[0][:2]) \
            or h * d != int(st.out_shapes[0][-1]):
        return None, False
    rope_idx = g.sole_consumer(rs.out_ids[0])
    if rope_idx is None \
            or g.steps[rope_idx].name != "rotary_embedding":
        return None, False
    rope = g.steps[rope_idx]
    attrs = rope.attrs or {}
    if "theta" not in attrs or "pos_offset" not in attrs:
        return None, False           # tensor offset: stays unfused
    # candidate exists: interior values are the projection + reshape
    if lin_out in g.external or rs.out_ids[0] in g.external:
        return "rejected", True
    has_bias = len(st.in_ids) == 3
    if not g.inputs_available(st.in_ids, i):
        return "rejected", True
    FF = _lazy_fused()
    fused = FusedStep(
        name="fused_rope_proj",
        fn=FF.rope_proj_lowering(h, float(attrs["theta"]),
                                 int(attrs["pos_offset"]), has_bias),
        in_ids=tuple(st.in_ids), out_ids=tuple(rope.out_ids),
        attrs={"num_heads": h, "theta": float(attrs["theta"]),
               "pos_offset": int(attrs["pos_offset"])},
        in_shapes=tuple(st.in_shapes),
        out_shapes=tuple(rope.out_shapes),
        pattern="rope_proj")
    return ("rope_proj", [i, rs_idx, rope_idx], fused), False


#: attempt order at each step index: most-specific first
_MATCHERS = (_match_rope_proj, _match_norm_linear, _match_residual_norm,
             _match_bias_act, _match_linear_act)


def fuse_steps(steps: Sequence, external_ids) -> Tuple[list, dict]:
    """Rewrite matched subgraphs; returns ``(plan, stats)``.

    ``plan`` preserves program order: unmatched records pass through
    untouched (same objects), each matched chain is replaced by ONE
    :class:`FusedStep` at the chain head's position. ``external_ids`` are
    value ids visible outside the op list (returns); interior values
    reaching them reject the match.
    """
    g = _Graph(steps, external_ids)
    stats = {"ops_before": len(g.steps), "matched": {}, "rewritten": {},
             "rejected": {}, "patterns": {}}
    consumed = set()
    replacement: Dict[int, FusedStep] = {}
    for i in range(len(g.steps)):
        if i in consumed:
            continue
        for matcher in _MATCHERS:
            res, rejected = matcher(g, i)
            if rejected:
                pattern = matcher.__name__.replace("_match_", "")
                stats["matched"][pattern] = \
                    stats["matched"].get(pattern, 0) + 1
                stats["rejected"][pattern] = \
                    stats["rejected"].get(pattern, 0) + 1
                if _metrics.enabled():
                    _m_matched.inc(pattern=pattern)
                    _m_rejected.inc(pattern=pattern)
                continue
            if res is None:
                continue
            pattern, idxs, fused = res
            if any(j in consumed for j in idxs):
                continue
            stats["matched"][pattern] = stats["matched"].get(pattern, 0) + 1
            stats["rewritten"][pattern] = \
                stats["rewritten"].get(pattern, 0) + 1
            if _metrics.enabled():
                _m_matched.inc(pattern=pattern)
                _m_rewritten.inc(pattern=pattern)
            consumed.update(idxs)
            fused.amp = getattr(g.steps[i], "amp", None)
            fused.loc = getattr(g.steps[i], "loc", "") or ""
            fused.grad = getattr(g.steps[i], "grad", None)
            replacement[i] = fused
            break
    plan: List = []
    for i, st in enumerate(g.steps):
        if i in replacement:
            plan.append(replacement[i])
        elif i not in consumed:
            plan.append(st)
    stats["ops_after"] = len(plan)
    stats["patterns"] = dict(stats["rewritten"])
    return plan, stats


# --------------------------------------------------------------------------
# to_static over Paddle-API callables: the op stream the dispatcher's
# recorder took (jit/program.py)
# --------------------------------------------------------------------------
def rewrite_program(program) -> dict:
    """Run the pass over a recorded ``Program`` and each of its regions
    apart (no chain crosses a region's edge); the plan replaces the
    steps. The returned outputs are the external values. Returns the
    stats, summed over the regions."""
    plan, stats = fuse_steps(program.steps, set(program.out_ids))
    if stats["rewritten"]:
        program.steps = plan
        program.plan()
    for region in program.regions():
        more = rewrite_program(region.program)
        for key, value in more.items():
            if isinstance(value, dict):
                for name, n in value.items():
                    stats[key][name] = stats[key].get(name, 0) + n
            else:
                stats[key] += value
    return stats


def fuse_program_ops(steps, fetch_ids) -> Tuple[list, dict]:
    """The ``static.Program`` adapter: its steps in, a replayable plan
    and the stats out. The fetched value ids are the external set, so a
    fetch of a value inside a chain rejects that fusion."""
    return fuse_steps(steps, set(fetch_ids))


def fuse_sot_nodes(nodes, out_refs):
    """The SOT adapter: a segment's nodes (``jit/sot`` steps whose value
    ids are ``("n", node, out)`` and ``("x", ext)`` refs) and the (node,
    out) pairs live at the flush, which are the external set. Returns
    ``(plan, stats)``: the plan is the step list, each chain replaced by
    its fused step, or None where nothing was rewritten (the segment runs
    its nodes as they are). The JAX package wraps each node in a
    ``_SotStep`` view; the port's nodes are steps already."""
    external = {("n", nid, k) for nid, k in out_refs}
    plan, stats = fuse_steps(nodes, external)
    return (plan if stats["rewritten"] else None), stats


def rewrite_traced(call, tensors, strict: bool = True):
    """Record ``call()`` (the Paddle-API ops it dispatches, its Tensor
    arguments ``tensors`` binding the program's inputs) and, with the
    flag on, rewrite the program. Returns ``(out, program, stats,
    recorder)``: ``out`` is the recorded call's eager result; ``out`` and
    ``program`` are None where a graph break ended the call
    (``recorder.broken``); ``stats`` None with the flag off."""
    from ...jit.program import record
    out, program, rec = record(call, (), {}, tensors, strict)
    stats = None
    if program is not None and enabled():
        stats = rewrite_program(program)
    return out, program, stats, rec
