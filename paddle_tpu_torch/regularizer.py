"""``paddle.regularizer`` of the port (counterpart of
``paddle_tpu/regularizer.py``): ``L1Decay`` and ``L2Decay``.

Both are folded into the gradient by the optimizer: L2Decay as
g + coeff * w, L1Decay as g + coeff * sign(w). One given as an
optimizer's ``weight_decay`` applies to every parameter; one given in a
parameter's ``ParamAttr(regularizer=...)`` applies to that parameter and
takes priority over the optimizer's (also over ``AdamW``'s decoupled
decay).
"""
from __future__ import annotations

__all__ = ["WeightDecayRegularizer", "L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def __init__(self, coeff: float = 0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self) -> float:
        return self._coeff

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self._coeff})"


class L1Decay(WeightDecayRegularizer):
    """loss += coeff * sum(|w|): the gradient gains coeff * sign(w)."""


class L2Decay(WeightDecayRegularizer):
    """loss += 0.5 * coeff * sum(w^2): the gradient gains coeff * w."""
