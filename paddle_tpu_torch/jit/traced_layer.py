"""``TracedLayer`` (counterpart of ``paddle_tpu/jit/traced_layer.py``):
the legacy trace-then-run API.

``TracedLayer.trace(layer, inputs)`` runs ``layer`` on ``inputs``
eagerly, returns those outputs, and a ``TracedLayer`` that replays the
captured program (``to_static``'s op-stream path) at the example's
shapes. ``save_inference_model`` writes that program with ``jit.save``
(a ``torch.export`` program and its parameters), loadable by
``jit.load`` and the inference ``Predictor``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

__all__ = ["TracedLayer"]


class TracedLayer:
    def __init__(self, static_fn, layer, example_inputs):
        self._fn = static_fn
        self._layer = layer
        self._example = list(example_inputs)

    @staticmethod
    def trace(layer, inputs: Sequence) -> Tuple[object, "TracedLayer"]:
        """Run ``layer`` on ``inputs`` eagerly (the returned outputs) and
        capture a program of its ops at their shapes."""
        from .api import to_static

        inputs = list(inputs)
        static_fn = to_static(lambda *xs: layer(*xs))
        dygraph_out = static_fn(*inputs)        # the recording call
        return dygraph_out, TracedLayer(static_fn, layer, inputs)

    def __call__(self, inputs: Sequence):
        return self._fn(*inputs)

    def set_strategy(self, build_strategy=None, exec_strategy=None):
        """Accepted for the JAX package's API; has no effect."""

    def save_inference_model(self, path: str, feed: List[int] = None,
                             fetch: List[int] = None, **kwargs):
        """Export the traced program with ``jit.save`` at the example's
        shapes (reference save_inference_model). ``fetch`` selects
        output indices of a multi-output trace; ``feed`` (dropping
        inputs) is rejected, as in the JAX package."""
        from .api import save
        from ..static import InputSpec

        if feed is not None:
            raise NotImplementedError(
                "save_inference_model(feed=...): input filtering is not "
                "supported for exported programs — export with the full "
                "input list")
        spec = [InputSpec.from_tensor(t) if hasattr(t, "shape") else t
                for t in self._example]
        layer = self._layer
        if fetch is not None:
            layer = _FetchFilter(layer, list(fetch))
        save(layer, path, input_spec=spec, **kwargs)
        return path


class _FetchFilter:
    """Output-index selection wrapper for multi-output traces."""

    def __init__(self, layer, fetch):
        self._layer = layer
        self._fetch = fetch

    def __getattr__(self, name):
        return getattr(self._layer, name)

    def forward(self, *xs, **kw):
        # explicit (not delegated): jit.save captures layer.forward
        out = self._layer(*xs, **kw)
        if not isinstance(out, (tuple, list)):
            out = (out,)
        picked = [out[i] for i in self._fetch]
        return picked[0] if len(picked) == 1 else tuple(picked)

    __call__ = forward
