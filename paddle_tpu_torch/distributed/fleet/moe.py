"""Mixture of experts (counterpart of ``paddle_tpu/distributed/fleet/moe.py``):
``TopKGate`` (GShard top-k routing with capacity: combine weights and
dispatch mask [N, E, C], and the load-balancing loss) and ``MoELayer``
(dispatch einsum, each expert on its slots, combine einsum).

The experts run one after another on this process; the JAX package's
expert-parallel sharding of the stacked experts over a mesh axis
(``ep_axis``) and its per-expert load metrics have no counterpart yet."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ...core import dispatch
from ...core.tensor import Tensor
from ...nn.layer.layers import Layer
from ...nn.parameter import ParamAttr


class TopKGate(Layer):
    """Top-k gating with capacity (``top_k`` 1 is the naive gate):
    tokens [N, H] -> (combine [N, E, C], dispatch [N, E, C], aux)."""

    def __init__(self, d_model: int, num_experts: int, top_k: int = 2,
                 capacity_factor: float = 1.25):
        super().__init__()
        from ...nn.initializer import Normal
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.weight = self.create_parameter(
            [d_model, num_experts],
            attr=ParamAttr(initializer=Normal(0.0, 0.02)))

    def _routing(self, logits):
        n, e = logits.shape
        k = self.top_k
        capacity = max(int(self.capacity_factor * n * k / e), 1)
        gates = torch.softmax(logits.float(), dim=-1)
        remaining = gates
        dev = logits.device
        combine = torch.zeros((n, e, capacity), device=dev)
        dispatch_mask = torch.zeros((n, e, capacity), dtype=torch.bool,
                                    device=dev)
        fill = torch.zeros((e,), device=dev)
        aux_ce = torch.zeros((e,), device=dev)
        for _ in range(k):
            idx = remaining.argmax(dim=-1)
            onehot = torch.nn.functional.one_hot(idx, e).float()
            pos = torch.cumsum(onehot, dim=0) - 1.0 + fill[None, :]
            in_cap = (pos < capacity) & (onehot > 0)
            slot = torch.nn.functional.one_hot(
                pos.clamp(0, capacity - 1).long(), capacity).float()
            mask = in_cap[..., None] * slot
            combine = combine + mask * gates.gather(1, idx[:, None])[:, :,
                                                                      None]
            dispatch_mask = dispatch_mask | (mask > 0)
            aux_ce = aux_ce + onehot.mean(dim=0)
            fill = fill + onehot.sum(dim=0)
            remaining = remaining * (1.0 - onehot)
        aux = (gates.mean(dim=0) * aux_ce).sum() * e / k
        return combine, dispatch_mask.float(), aux

    def forward(self, x: Tensor):
        return dispatch.call("moe_gate", lambda xa, wa: self._routing(
            xa.reshape(-1, xa.shape[-1]) @ wa), [x, self.weight])


class _ExpertMLP(Layer):
    """The default expert: a two-layer tanh-GELU MLP."""

    def __init__(self, d_model: int, d_hidden: int):
        super().__init__()
        from ...nn import Linear
        self.fc1 = Linear(d_model, d_hidden)
        self.fc2 = Linear(d_hidden, d_model)

    def forward(self, x):
        from ...nn import functional as F
        return self.fc2(F.gelu(self.fc1(x), approximate=True))


class MoELayer(Layer):
    """``num_experts`` experts of one structure behind ``gate``; the
    latest forward's load-balancing loss is ``self.l_aux``."""

    def __init__(self, d_model: int, num_experts: int,
                 experts: Optional[Sequence[Layer]] = None,
                 d_hidden: Optional[int] = None, top_k: int = 2,
                 capacity_factor: float = 1.25, gate: Optional[Layer] = None,
                 ep_axis: str = "mp"):
        super().__init__()
        from ...nn import LayerList
        self.num_experts = num_experts
        self.ep_axis = ep_axis
        self.gate = gate or TopKGate(d_model, num_experts, top_k,
                                     capacity_factor)
        if experts is None:
            experts = LayerList([_ExpertMLP(d_model, d_hidden or 4 * d_model)
                                 for _ in range(num_experts)])
        elif not isinstance(experts, LayerList):
            experts = LayerList(list(experts))
        if len(experts) != num_experts:
            raise ValueError(f"{len(experts)} experts != num_experts="
                             f"{num_experts}")
        shapes = [[tuple(p.shape) for p in ex.parameters()] for ex in experts]
        if any(s != shapes[0] for s in shapes):
            raise ValueError("experts must be identical in structure")
        self.experts = experts
        self.l_aux: Optional[Tensor] = None

    def forward(self, x: Tensor) -> Tensor:
        combine, dispatch_mask, aux = self.gate(x)
        self.l_aux = aux
        experts = list(self.experts)

        def body(xa, ca, da, *_params):
            tokens = xa.reshape(-1, xa.shape[-1])
            ein = torch.einsum("nec,nh->ech", da, tokens.float()).to(
                tokens.dtype)
            with dispatch.quiet_scope():
                eout = torch.stack([ex(Tensor(ein[i]))._data
                                    for i, ex in enumerate(experts)])
            y = torch.einsum("nec,ech->nh", ca, eout.float())
            return y.to(tokens.dtype).reshape(xa.shape)
        params = [p for ex in experts for p in ex.parameters()]
        return dispatch.call("moe_layer", body,
                             [x, combine, dispatch_mask, *params])


from ...ops import registry as _op_registry  # noqa: E402

_op_registry.register("moe_gate", "nn_common")(TopKGate.forward)
_op_registry.register("moe_layer", "nn_common")(MoELayer.forward)
