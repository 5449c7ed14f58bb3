"""Device-memory census with attribution tags (counterpart of
``paddle_tpu/observability/perf/memory.py``).

Attribution is holder-based: a subsystem that owns long-lived device
buffers registers a provider (a callable yielding its current tensors)
when it allocates them. ``nn.Parameter`` tracks every live parameter
(``params``, and their gradients under ``grads``), an ``Optimizer`` its
moments and fp32 masters (``optimizer_state``), a serving engine its KV
pages (``kv_cache``). Providers are weakly bound, so a dropped engine or
optimizer unregisters itself by dying.

A tensor is counted once per storage (``untyped_storage()``): views
share their base's storage, and counting them by tensor would count the
bytes twice. A storage two providers yield counts once, for the first
tag that claims it (registration order).

``activations`` is the unclaimed rest: on CUDA,
``torch.cuda.memory_allocated()`` minus the bytes the providers claimed
on that card (the transient forward and autograd values, the
allocator's rounding). On the CPU it is 0: the port has no census of
live host tensors (the JAX package walks ``jax.live_arrays()``).

High-water marks are kept per *phase* (train_step / prefill / decode /
…): ``update_high_water(phase)`` takes a census and keeps the phase's
maximum, exported as the ``paddle_tpu_hbm_*`` metric family.
"""
from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, Iterable, Optional

import torch

from .. import metrics as _metrics

__all__ = ["register_provider", "unregister_provider", "register_object",
           "track_parameter", "census", "update_high_water", "high_water",
           "reset_high_water", "refresh_metrics", "TAGS"]

#: the closed tag vocabulary (census() keys; "activations" is the
#: unclaimed rest)
TAGS = ("params", "grads", "optimizer_state", "kv_cache", "activations")

_lock = threading.Lock()
#: provider id -> (tag, callable returning an iterable of tensors)
_providers: Dict[int, tuple] = {}
_next_id = [0]

_high_water: Dict[str, float] = {}
_high_water_by_tag: Dict[tuple, float] = {}

M_HBM_LIVE = _metrics.gauge(
    "paddle_tpu_hbm_live_bytes",
    "Live device bytes by attribution tag (census-time).",
    labelnames=("tag",))
M_HBM_HIGH_WATER = _metrics.gauge(
    "paddle_tpu_hbm_high_water_bytes",
    "Max census total observed per phase (update_high_water sites).",
    labelnames=("phase",))


def register_provider(tag: str, fn: Callable[[], Iterable]) -> int:
    """Register a census provider: ``fn()`` yields the tensors (or Paddle
    Tensors) currently owned under ``tag``. Returns a handle for
    ``unregister_provider``."""
    with _lock:
        pid = _next_id[0]
        _next_id[0] += 1
        _providers[pid] = (tag, fn)
    return pid


def unregister_provider(pid: int):
    with _lock:
        _providers.pop(pid, None)


def register_object(tag: str, obj, getter: Callable) -> int:
    """Weakly bound provider: ``getter(obj)`` yields the tensors while
    ``obj`` is alive; the provider dies (and unregisters) with the object,
    so telemetry never keeps an engine or an optimizer alive."""
    ref = weakref.ref(obj)

    def fn():
        o = ref()
        return getter(o) if o is not None else ()

    pid = register_provider(tag, fn)
    try:
        weakref.finalize(obj, unregister_provider, pid)
    except TypeError:
        pass
    return pid


def _payload(x):
    """The torch payload of a Paddle Tensor or Parameter."""
    return getattr(x, "_data", x)


def _iter_leaves(xs):
    """Flatten provider output: tensors, Paddle Tensors, and nested
    tuples/lists/dicts of them (optimizer accumulators hold dicts of
    encoded moments)."""
    import types

    stack = [xs]
    while stack:
        x = stack.pop()
        if x is None:
            continue
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple, set, frozenset,
                            types.GeneratorType)):
            stack.extend(x)
        else:
            p = _payload(x)
            if isinstance(p, torch.Tensor):
                yield p


def _storage(t: torch.Tensor):
    """(key, bytes) of ``t``'s storage, or None for a meta tensor (no
    memory)."""
    if t.device.type == "meta":
        return None
    st = t.untyped_storage()
    return (t.device.type, t.device.index, st.data_ptr()), st.nbytes()


def census(include_unclaimed: bool = True,
           refresh_metrics: bool = False) -> Dict[str, float]:
    """Bytes of live device storages by attribution tag, each storage
    counted once, for the first tag that claims it. With
    ``include_unclaimed`` the allocator's remainder on each CUDA device
    the providers' storages lie on (every initialized card) is
    ``activations``."""
    with _lock:
        providers = list(_providers.values())
    out: Dict[str, float] = {t: 0.0 for t in TAGS}
    claimed: Dict[tuple, str] = {}
    claimed_by_card: Dict[int, float] = {}
    for tag, fn in providers:
        try:
            leaves = list(_iter_leaves(fn()))
        except Exception:
            continue
        for a in leaves:
            st = _storage(a)
            if st is None:
                continue
            key, nbytes = st
            if key in claimed or not nbytes:
                continue
            claimed[key] = tag
            out[tag] = out.get(tag, 0.0) + nbytes
            if key[0] == "cuda":
                claimed_by_card[key[1]] = (claimed_by_card.get(key[1], 0.0)
                                           + nbytes)
    if include_unclaimed and torch.cuda.is_available() \
            and torch.cuda.is_initialized():
        for dev in range(torch.cuda.device_count()):
            allocated = torch.cuda.memory_allocated(dev)
            out["activations"] += max(
                0.0, allocated - claimed_by_card.get(dev, 0.0))
    out["total"] = sum(v for k, v in out.items() if k != "total")
    if refresh_metrics and _metrics.enabled():
        for tag, v in out.items():
            if tag != "total":
                M_HBM_LIVE.set(v, tag=tag)
    return out


def update_high_water(phase: str = "default") -> Dict[str, float]:
    """Census + per-phase high-water update. Call at a phase's points of
    peak pressure (inside a train step, at the end of a prefill chunk);
    the metric family exports each phase's maximum total."""
    c = census(refresh_metrics=True)
    with _lock:
        if c["total"] >= _high_water.get(phase, -1.0):
            _high_water[phase] = c["total"]
            for tag in TAGS:
                _high_water_by_tag[(phase, tag)] = c.get(tag, 0.0)
        hw = _high_water[phase]
    if _metrics.enabled():
        M_HBM_HIGH_WATER.set(hw, phase=phase)
    return c


def high_water(phase: Optional[str] = None):
    """Per-phase high-water totals, or one phase's ``{"total": …,
    tags…}`` breakdown at its high water."""
    with _lock:
        if phase is None:
            return dict(_high_water)
        out = {"total": _high_water.get(phase, 0.0)}
        for tag in TAGS:
            out[tag] = _high_water_by_tag.get((phase, tag), 0.0)
        return out


def reset_high_water():
    with _lock:
        _high_water.clear()
        _high_water_by_tag.clear()


def refresh_metrics() -> Dict[str, float]:
    """Census with the ``paddle_tpu_hbm_live_bytes`` gauges updated (the
    metrics-dump sites call it, so a saved snapshot carries the
    attributed breakdown)."""
    return census(refresh_metrics=True)


# ----------------------------------------------------------------- params
# Parameters register in a process-wide WeakSet (nn/parameter.py); their
# gradients ride the same walk.
_live_params: "weakref.WeakSet" = weakref.WeakSet()


def track_parameter(p):
    """Called by ``nn.Parameter.__init__``: O(1), no census cost."""
    try:
        _live_params.add(p)
    except TypeError:
        pass


def _params_arrays():
    for p in list(_live_params):
        yield getattr(p, "_data", None)


def _grads_arrays():
    for p in list(_live_params):
        d = getattr(p, "_data", None)
        g = getattr(d, "grad", None) if isinstance(d, torch.Tensor) else None
        if g is not None:
            yield g


register_provider("params", _params_arrays)
register_provider("grads", _grads_arrays)
