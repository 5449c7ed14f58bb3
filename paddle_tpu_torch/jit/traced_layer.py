"""``TracedLayer`` (counterpart of ``paddle_tpu/jit/traced_layer.py``):
the legacy trace-then-run API.

``TracedLayer.trace(layer, inputs)`` runs ``layer`` on ``inputs``
eagerly, returns those outputs, and a ``TracedLayer`` that replays the
captured program (``to_static``'s op-stream path) at the example's
shapes. ``save_inference_model`` waits for ``jit.save`` (ROADMAP).
"""
from __future__ import annotations

from typing import Sequence, Tuple

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

    def save_inference_model(self, path: str, feed=None, fetch=None,
                             **kwargs):
        raise NotImplementedError(
            "later slice: TracedLayer.save_inference_model waits for "
            "jit.save")
