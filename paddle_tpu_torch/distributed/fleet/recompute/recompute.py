"""Recompute, activation checkpointing (counterpart of
``paddle_tpu/distributed/fleet/recompute/recompute.py``).

``recompute(function, *args)`` runs ``function`` under
``torch.utils.checkpoint`` (without reentry): the forward keeps only the
segment's inputs, and the backward runs the forward again to rebuild
what it needs. Parameter gradients accumulate as without recompute.

What the replay must see again, the forward snapshots:

* the port's explicit ``torch.Generator``s (dropout draws from the
  model's own generator, never from torch's global RNG, which is all
  that ``torch.utils.checkpoint`` restores). The replay runs from the
  forward's snapshot, and afterwards each generator is put back where it
  stood before the replay, so it ends where it would without recompute;
* the amp state (``amp.auto_cast``), since the backward usually runs
  after the ``auto_cast`` block has closed.

Over Paddle ``Tensor``s and ``Layer``s (any Tensor argument) the
checkpoint holds the arguments' payloads, the segment runs on fresh
Tensors over them, and the generators it snapshots are the Paddle API's
(``core.generator.default_generator`` of the arguments' devices), from
which the Paddle-API dropout draws: the rerun draws the same masks.
"""
from __future__ import annotations

from typing import Any, List

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ....amp.state import amp_state, amp_state_as
from ....core.generator import default_generator, get_rng_state, set_rng_state
from ....core.tensor import Tensor


def _discover_generators(function) -> List[torch.Generator]:
    """The ``generator`` attributes of ``function``'s modules (a module,
    or a bound method of one), each once."""
    owner = function if isinstance(function, nn.Module) \
        else getattr(function, "__self__", None)
    if not isinstance(owner, nn.Module):
        return []
    found: List[torch.Generator] = []
    for mod in owner.modules():
        g = getattr(mod, "generator", None)
        if isinstance(g, torch.Generator) and all(g is not f for f in found):
            found.append(g)
    return found


def recompute(function, *args, **kwargs):
    """Run ``function(*args, **kwargs)`` keeping none of its intermediate
    activations; the backward runs it again.

    Options (popped, the rest go to ``function``): ``preserve_rng_state``
    (default True) replays the generators' draws in the recompute;
    ``generators`` lists them (default: the ``generator`` attributes of
    ``function``'s modules). ``use_reentrant`` and ``params`` are taken
    for the JAX package's signature and have no effect: the checkpoint
    never reenters, and autograd finds the parameters itself.
    """
    preserve = kwargs.pop("preserve_rng_state", True)
    generators = kwargs.pop("generators", None)
    kwargs.pop("use_reentrant", None)
    kwargs.pop("params", None)
    paddle = any(isinstance(a, Tensor) for a in args)
    if generators is None:
        generators = (_paddle_generators(args) if paddle
                      else _discover_generators(function))
    gens = list(generators) if preserve else []
    forward_state: list = []

    def run(*inputs):
        if not forward_state:                      # the forward
            forward_state.append((get_rng_state(gens), amp_state()))
            return function(*inputs, **kwargs)
        rng, amp = forward_state[0]                # a replay in the backward
        after = get_rng_state(gens)
        set_rng_state(gens, rng)
        try:
            with amp_state_as(amp):
                return function(*inputs, **kwargs)
        finally:
            set_rng_state(gens, after)

    if not paddle:
        return checkpoint(run, *args, use_reentrant=False,
                          preserve_rng_state=preserve)
    slots = [i for i, a in enumerate(args) if isinstance(a, Tensor)]
    shape: list = []

    def run_payloads(*payloads):
        full = list(args)
        for i, p in zip(slots, payloads):
            full[i] = Tensor(p)
        out = run(*full)
        single = isinstance(out, Tensor)
        outs = [out] if single else list(out)
        shape[:] = [single, [isinstance(o, Tensor) for o in outs],
                    [None if isinstance(o, Tensor) else o for o in outs]]
        return tuple(o._data for o in outs if isinstance(o, Tensor))

    got = iter(checkpoint(run_payloads, *[args[i]._data for i in slots],
                          use_reentrant=False, preserve_rng_state=preserve))
    single, is_tensor, others = shape
    outs = [Tensor(next(got)) if t else o for t, o in zip(is_tensor, others)]
    return outs[0] if single else tuple(outs)


def _paddle_generators(args) -> List[torch.Generator]:
    """The Paddle-API generators of the devices of ``args``' Tensors."""
    devices = {str(a._data.device): a._data.device for a in args
               if isinstance(a, Tensor)}
    return [default_generator(d) for d in devices.values()]


def recompute_sequential(ctx: dict, functions, *args, **kwargs):
    """Chunked recompute over a sequence of layers: ``functions`` (a list,
    or a module whose children run in order) is split into
    ``ctx["segments"]`` chunks, and each chunk is one ``recompute``."""
    ctx = dict(ctx or {})
    segments = int(ctx.get("segments", 1))
    preserve = bool(ctx.get("preserve_rng_state", True))
    if isinstance(functions, nn.Module):
        functions = list(functions.children())
    functions = list(functions)
    if not functions:
        raise ValueError("recompute_sequential needs at least one function")
    n = len(functions)
    per = max(n // max(segments, 1), 1)

    def run_chunk(chunk):
        def f(*xs):
            out = xs if len(xs) > 1 else xs[0]
            for fn in chunk:
                out = fn(*out) if isinstance(out, tuple) else fn(out)
            return out
        return f

    out: Any = args
    for start in range(0, n, per):
        chunk = functions[start:start + per]
        gens = [g for fn in chunk for g in _discover_generators(fn)]
        inputs = out if isinstance(out, tuple) else (out,)
        out = recompute(run_chunk(chunk), *inputs, preserve_rng_state=preserve,
                        generators=list({id(g): g for g in gens}.values()),
                        **kwargs)
    return out
