"""In-graph data-dependent control flow: ``cond``, ``while_loop``, ``case``
and ``switch_case`` (counterpart of ``paddle_tpu/ops/control_flow.py``).

Each construct runs in one of two modes, decided per call:

* **eager**: no ``to_static`` recording is active (or its recording has
  already broken). The predicate is read on the host and only the taken
  branch runs, so torch autograd runs through the taken branch and, in
  ``while_loop``, through the unrolled iterations.
* **captured**: a ``to_static`` recording or an SOT capture is active,
  or the call sits inside another construct's branch trace. The branch
  callables are first traced abstractly: a ``BranchTrace`` takes every
  op the dispatcher would run (``dispatch.enter_branch_trace``), runs its
  torch body on meta tensors (shapes and dtypes, no data and no kernel) and
  notes the tensors the branch reads that it did not make. The whole
  construct then goes through ``dispatch.call`` as one op whose operands
  are the predicate (or the carry) and every tensor a branch reads, so
  the recorder (``jit/program.py``) takes one step, or an SOT segment
  one deferred op (its shapes from the lowering on meta tensors, where
  the predicate is not read), and none of the branches' ops, and
  gradients reach the parameters a branch closes over.

The op's body (its "lowering") reads the predicate, or the loop's trip
condition, from the payload it is given and runs the chosen callable
with the read tensors rebound to the op's operands, its inner ops kept
out of the recording (``dispatch.quiet_scope``, no capture). So the
read of the predicate belongs to the op's run, not to the recording: a
program recorded while one branch ran, or at one trip count, takes the
other branch and another trip count on replay.

Where the port differs from the JAX package:

* the JAX lowering is ``lax.cond``/``lax.switch``/``lax.while_loop``,
  which compile both branches into the program and read the predicate on
  the device. The port's replay runs the chosen callable's ops eagerly,
  so each ``cond`` reads its predicate on the host once, and each
  ``while_loop`` iteration reads its condition once (one host sync an
  iteration).
* the abstract trace runs the torch bodies on meta tensors, where the
  JAX package uses ``jax.eval_shape``. A body that reads a value on the
  host (``item``, a data-dependent shape) cannot be traced in either.
* ``cond`` and ``switch_case`` differentiate through torch autograd of
  the op's run; ``while_loop``'s captured outputs are forward-only, as
  ``lax.while_loop``'s are.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from ..core import dispatch
from ..core.tensor import (Tensor, active_capture, active_sot, as_tensor,
                           capture_scope)
from .registry import register

__all__ = ["cond", "while_loop", "case", "switch_case"]


# ------------------------------------------------------------- pytrees
def _tree(out, where: str):
    """(structure, Tensor leaves) of nested lists, tuples and dicts of
    Tensors (None is an empty subtree); any other leaf raises
    TypeError."""
    leaves: List[Tensor] = []
    return _tree_rec(out, leaves, where), leaves


def _tree_rec(o, leaves, where):
    if isinstance(o, Tensor):
        leaves.append(o)
        return "T"
    if o is None:
        return "N"
    if isinstance(o, (list, tuple)):
        return (type(o), tuple(_tree_rec(x, leaves, where) for x in o))
    if isinstance(o, dict):
        keys = sorted(o)
        return (dict, tuple(keys),
                tuple(_tree_rec(o[k], leaves, where) for k in keys))
    raise TypeError(
        f"{where} must return Tensors (or nested lists/tuples/dicts of "
        f"Tensors, or None); got a {type(o).__name__} leaf")


def _untree(structure, leaves: Sequence):
    return _untree_rec(structure, iter(leaves))


def _untree_rec(s, it):
    if s == "T":
        return next(it)
    if s == "N":
        return None
    if s[0] is dict:
        return {k: _untree_rec(v, it) for k, v in zip(s[1], s[2])}
    return s[0](_untree_rec(v, it) for v in s[1])


def _fmt(structure) -> str:
    if structure == "T":
        return "*"
    if structure == "N":
        return "None"
    if structure[0] is dict:
        return "{" + ", ".join(f"{k!r}: {_fmt(v)}"
                               for k, v in zip(structure[1], structure[2])) + "}"
    inner = ", ".join(_fmt(v) for v in structure[1])
    return f"[{inner}]" if structure[0] is list else f"({inner})"


# ------------------------------------------------------ abstract trace
def _meta(d: torch.Tensor) -> torch.Tensor:
    if d.is_meta:
        return d
    # an SOT placeholder (``jit.sot.LazyArray``) answers shape, strides
    # and dtype without its value
    return torch.empty_strided(tuple(d.shape), d.stride(), dtype=d.dtype,
                               device="meta")


class BranchTrace:
    """The dispatcher's interceptor while a branch callable is traced:
    each op runs its torch body on meta tensors; the tensors the branch
    reads that this trace did not make are noted, in first-read order
    (they become the operands of the construct's op)."""

    def __init__(self):
        self.reads: List[Tensor] = []
        self._read_ids = set()
        self._produced = set()      # id(payload) of this trace's outputs

    def note_read(self, t: Tensor) -> None:
        if id(t._data) not in self._produced and id(t) not in self._read_ids:
            self._read_ids.add(id(t))
            self.reads.append(t)

    def run_op(self, op_name, fn, tensor_inputs, attrs, mask):
        from ..amp.state import amp_cast
        for t in tensor_inputs:
            self.note_read(t)
        metas = amp_cast(op_name, *[_meta(t._data) for t in tensor_inputs])
        # the trace steps aside while the body runs: a nested construct's
        # lowering dispatches its branches' ops for real (on meta tensors)
        prev = dispatch.enter_branch_trace(None)
        try:
            with torch.no_grad():
                out = fn(*metas, **attrs)
        except Exception as e:
            raise RuntimeError(
                f"op '{op_name}' inside a control-flow branch cannot be "
                f"traced abstractly ({type(e).__name__}: {e}); branches "
                f"under capture must be shape-static tensor programs"
            ) from e
        finally:
            dispatch.exit_branch_trace(prev)
        multi = isinstance(out, (tuple, list))
        ts = []
        for o in (list(out) if multi else [out]):
            self._produced.add(id(o))
            ts.append(Tensor(o))
        return ts if multi else ts[0]


def _trace_branch(fn: Callable, args: Sequence[Tensor] = (),
                  where: str = "branch"):
    """Trace ``fn(*args)`` abstractly. Returns (structure, leaf
    (shape, dtype) pairs, the tensors it reads)."""
    bt = BranchTrace()
    for a in args:                  # its arguments are its own, not reads
        bt._produced.add(id(a._data))
    prev = dispatch.enter_branch_trace(bt)
    try:
        with torch.no_grad():
            out = fn(*args)
    finally:
        dispatch.exit_branch_trace(prev)
    structure, leaves = _tree(out, where)
    # a branch that returns a tensor it did not touch (cond(p, lambda: x,
    # lambda: y)) reads it all the same: an operand, not a constant
    for leaf in leaves:
        bt.note_read(leaf)
    avals = [(tuple(leaf.shape), leaf.dtype) for leaf in leaves]
    return structure, avals, bt.reads


def _dedup(*groups) -> List[Tensor]:
    seen, out = set(), []
    for g in groups:
        for t in g:
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
    return out


def _check_same(traced, what: str) -> None:
    s0, av0 = traced[0][0], traced[0][1]
    for i, (s, av, _r) in enumerate(traced[1:], start=1):
        if s != s0:
            raise ValueError(
                f"{what}: branch 0 and branch {i} return different "
                f"structures ({_fmt(s0)} vs {_fmt(s)})")
        for j, (a0, a) in enumerate(zip(av0, av)):
            if a0 != a:
                raise ValueError(
                    f"{what}: output {j} differs between branch 0 "
                    f"({a0[0]}, {a0[1]}) and branch {i} ({a[0]}, {a[1]}); "
                    f"branches must return matching shapes/dtypes")


class _rebound:
    """Swap the payloads of ``tensors`` for ``arrays`` inside the block
    (the op's operands, while a branch runs in its lowering)."""

    def __init__(self, tensors: Sequence[Tensor], arrays: Sequence):
        self._tensors, self._arrays = tensors, arrays

    def __enter__(self):
        self._saved = [t._data for t in self._tensors]
        for t, a in zip(self._tensors, self._arrays):
            t._data = a
        return self

    def __exit__(self, *exc):
        for t, d in zip(self._tensors, self._saved):
            t._data = d
        return False


class _inner:
    """The block runs a branch inside an op: its ops are not recorded
    and it sees no capture (a nested construct runs eagerly)."""

    def __enter__(self):
        self._quiet = dispatch.quiet_scope().__enter__()
        self._cap = capture_scope(None)
        self._cap.__enter__()
        return self

    def __exit__(self, *exc):
        self._cap.__exit__(*exc)
        self._quiet.__exit__(*exc)
        return False


def _fresh(outs: Sequence[torch.Tensor], ins: Sequence) -> tuple:
    """The op's outputs, each a new tensor object: an output that is one
    of the operands (a branch that returns what it read) becomes a view
    of it, so the recorder sees a value of its own."""
    ids = {id(a) for a in ins}
    return tuple(o.view_as(o) if id(o) in ids else o for o in outs)


def _captured() -> bool:
    """Whether the construct is recorded as one op: a ``to_static``
    recording is active (and not broken), an SOT capture is (the op joins
    its segment), or a branch is being traced."""
    if dispatch.in_branch_trace() or active_sot() is not None:
        return True
    rec = active_capture()
    return rec is not None and rec.root.broken is None


def _scalar_pred(t, what: str) -> Tensor:
    t = t if isinstance(t, Tensor) else as_tensor(t)
    if t._data.numel() != 1:
        raise ValueError(f"{what} must be a scalar (one-element) tensor, "
                         f"got shape {tuple(t.shape)}")
    return t


def _truth(a: torch.Tensor) -> bool:
    """The host read of a predicate payload (the op's own read)."""
    return bool(a.reshape(()).item())


# ------------------------------------------------------------------ cond
def _select_lowering(fns, ext, avals, keys=None, default_pos=None):
    """cond/switch_case's op body: the selector payload and the read
    tensors' payloads -> the chosen branch's output payloads."""

    def lowering(sel, *ext_arrays):
        if sel.is_meta:             # inside an outer trace: shapes only
            pos = 0
        elif keys is None:
            pos = 0 if _truth(sel) else 1
        else:
            i = int(sel.reshape(()).item())
            pos = keys.index(i) if i in keys else default_pos
        with _inner(), _rebound(ext, ext_arrays):
            _s, leaves = _tree(fns[pos](), "branch")
            outs = [leaf._data for leaf in leaves]
        outs = [o if o.dtype == av[1] else o.to(av[1])
                for o, av in zip(outs, avals)]
        return _fresh(outs, ext_arrays)

    return lowering


@register("conditional_block", category="control_flow")
def cond(pred, true_fn=None, false_fn=None, name=None, return_names=None):
    """``true_fn()`` if ``pred`` else ``false_fn()``. Under capture both
    branches are traced and the construct is one op; gradients flow
    through the branch that runs. The callables take no arguments, may
    close over any tensors, and must return the same structure of
    tensors."""
    pred = _scalar_pred(pred, "cond(pred)")
    if not _captured():
        taken = true_fn if bool(pred) else false_fn
        return taken() if taken is not None else None
    if true_fn is None or false_fn is None:
        raise ValueError("cond under capture requires both true_fn and "
                         "false_fn (a one-sided cond has no graph form)")
    traced = [_trace_branch(true_fn, where="cond true_fn"),
              _trace_branch(false_fn, where="cond false_fn")]
    _check_same(traced, "cond")
    structure, avals = traced[0][0], traced[0][1]
    ext = _dedup(*[r for _s, _a, r in traced])
    outs = dispatch.call(
        "conditional_block", _select_lowering([true_fn, false_fn], ext,
                                              avals),
        [pred] + ext, differentiable_mask=[False] + [True] * len(ext))
    return _untree(structure, outs if isinstance(outs, list) else [outs])


# ------------------------------------------------------------ while_loop
@register("while_loop", category="control_flow", differentiable=False)
def while_loop(cond, body, loop_vars, is_test=False, name=None):
    """Repeat ``body(*loop_vars)`` while ``cond(*loop_vars)`` holds.
    ``loop_vars`` is a non-empty list or tuple whose (nested) tensor
    leaves are the carried state; ``body`` returns the same structure with
    the same shapes and dtypes. Under capture the loop is one op whose
    outputs take no gradient; eagerly, autograd runs through the unrolled
    iterations."""
    if not isinstance(loop_vars, (list, tuple)) or not loop_vars:
        raise TypeError("while_loop: loop_vars must be a non-empty "
                        "list/tuple")
    was_list = isinstance(loop_vars, list)
    carry_def, raw = _tree(tuple(loop_vars), "while_loop loop_vars")
    leaves = list(raw)

    def rebuild(ls):
        vars_ = _untree(carry_def, ls)
        return list(vars_) if was_list else vars_

    def norm_out(out):
        # a list for a tuple (or back), and a single var returned bare,
        # are accepted; only the nesting must match
        if isinstance(out, list):
            out = tuple(out)
        if len(loop_vars) == 1 and not (isinstance(out, tuple)
                                        and len(out) == 1):
            out = (out,)
        return out

    def body_leaves(out):
        s, ls = _tree(norm_out(out), "while_loop body")
        if s != carry_def:
            raise ValueError(
                f"while_loop: body returned a different structure than "
                f"loop_vars ({_fmt(s)} vs {_fmt(carry_def)})")
        return ls

    def keep_going(out) -> Tensor:
        _s, ks = _tree(out, "while_loop cond")
        if len(ks) != 1 or ks[0]._data.numel() != 1:
            raise ValueError("while_loop: cond must return one scalar "
                             "boolean tensor, got "
                             f"{[tuple(k.shape) for k in ks]}")
        return ks[0]

    if not _captured():
        vars_ = _untree(carry_def, leaves)
        while bool(keep_going(cond(*vars_))):
            vars_ = _untree(carry_def, body_leaves(body(*vars_)))
        return rebuild(_tree(vars_, "while_loop")[1])

    avals = [(tuple(t.shape), t.dtype) for t in leaves]
    n_carry = len(leaves)
    ph = [Tensor(_meta(t._data)) for t in leaves]
    c_s, c_av, c_reads = _trace_branch(
        lambda *ps: cond(*_untree(carry_def, ps)), ph, "while_loop cond")
    if len(c_av) != 1 or torch.Size(c_av[0][0]).numel() != 1:
        raise ValueError("while_loop: cond must return one scalar boolean "
                         f"tensor, got {[a[0] for a in c_av]}")
    ph = [Tensor(_meta(t._data)) for t in leaves]
    b_s, b_av, b_reads = _trace_branch(
        lambda *ps: norm_out(body(*_untree(carry_def, ps))), ph,
        "while_loop body")
    if b_s != carry_def:
        raise ValueError(
            f"while_loop: body returned a different structure than "
            f"loop_vars ({_fmt(b_s)} vs {_fmt(carry_def)})")
    for j, (a0, a) in enumerate(zip(avals, b_av)):
        if a0 != a:
            raise ValueError(
                f"while_loop: carried value {j} changes from ({a0[0]}, "
                f"{a0[1]}) to ({a[0]}, {a[1]}) across one iteration; the "
                f"loop-carried state must be shape/dtype invariant")
    ext = _dedup(c_reads, b_reads)

    def lowering(*arrays):
        carry = list(arrays[:n_carry])
        if not any(a.is_meta for a in arrays):
            with _inner(), torch.no_grad(), _rebound(ext, arrays[n_carry:]):
                while _truth(keep_going(cond(*_untree(
                        carry_def, [Tensor(a) for a in carry])))._data):
                    out = body_leaves(body(*_untree(
                        carry_def, [Tensor(a) for a in carry])))
                    carry = [o._data for o in out]
        return _fresh(carry, arrays)

    with torch.no_grad():
        outs = dispatch.call("while_loop", lowering, leaves + ext,
                             differentiable_mask=[False] * (n_carry
                                                            + len(ext)))
    return rebuild(outs if isinstance(outs, list) else [outs])


# --------------------------------------------------- case / switch_case
@register("case", category="control_flow")
def case(pred_fn_pairs, default=None, name=None):
    """The first pair whose predicate holds runs; ``default`` runs when
    none does, and with no ``default`` the last pair's callable plays
    that role. Built as nested ``cond``s, so it records as one op."""
    if not isinstance(pred_fn_pairs, (list, tuple)) or not pred_fn_pairs:
        raise TypeError("case: pred_fn_pairs must be a non-empty "
                        "list/tuple of (pred, fn) pairs")
    pairs = []
    for p in pred_fn_pairs:
        if not isinstance(p, (list, tuple)) or len(p) != 2 \
                or not callable(p[1]):
            raise TypeError("case: each entry must be a (scalar bool "
                            "Tensor, callable) pair")
        pairs.append((p[0], p[1]))
    if default is None:
        pairs, default = pairs[:-1], pairs[-1][1]
    if not pairs:
        return default()

    def chain(i):
        if i == len(pairs):
            return default()
        p, f = pairs[i]
        return cond(p, f, lambda: chain(i + 1))

    return chain(0)


@register("switch_case", category="control_flow")
def switch_case(branch_index, branch_fns, default=None, name=None):
    """Run the branch whose integer key equals ``branch_index``.
    ``branch_fns`` is a list of callables (keys 0..n-1) or of (key,
    callable) pairs; an index no key matches runs ``default``, or, with
    no ``default``, the callable of the largest key. Under capture the
    table is one op."""
    if isinstance(branch_fns, (list, tuple)) and branch_fns \
            and callable(branch_fns[0]):
        items = list(enumerate(branch_fns))
    else:
        items = [(int(k), f) for k, f in branch_fns]
    keys = [k for k, _ in items]
    if len(set(keys)) != len(keys):
        raise ValueError(f"switch_case: duplicate branch keys {keys}")
    items.sort(key=lambda kv: kv[0])
    idx = _scalar_pred(branch_index, "switch_case(branch_index)")

    if not _captured():
        i = int(idx)
        for k, f in items:
            if k == i:
                return f()
        return default() if default is not None else items[-1][1]()

    fns = [f for _, f in items]
    if default is not None:
        fns.append(default)
    traced = [_trace_branch(f, where="switch_case branch") for f in fns]
    _check_same(traced, "switch_case")
    structure, avals = traced[0][0], traced[0][1]
    ext = _dedup(*[r for _s, _a, r in traced])
    outs = dispatch.call(
        "switch_case", _select_lowering(fns, ext, avals,
                                        keys=[k for k, _ in items],
                                        default_pos=len(fns) - 1),
        [idx] + ext, differentiable_mask=[False] + [True] * len(ext))
    return _untree(structure, outs if isinstance(outs, list) else [outs])
