"""nn.utils (counterpart of ``paddle_tpu/nn/utils/``): gradient
clipping in place, parameters to and from one vector, and the weight
norm reparameterization."""
from __future__ import annotations

import torch

from ...core import dispatch
from ...core.tensor import Tensor


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every gradient by min(1, max_norm / (total norm + 1e-6)), the
    scale staying on the device; returns the total norm (fp32)."""
    if isinstance(parameters, Tensor):
        parameters = [parameters]
    grads = [p._data.grad for p in parameters if p._data.grad is not None]
    if not grads:
        return Tensor(torch.zeros(()))
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max().float() for g in grads]).max()
    else:
        total = sum((g.float().abs() ** norm_type).sum() for g in grads) \
            ** (1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError("the total norm of gradients is non-finite; "
                           "disable with error_if_nonfinite=False")
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef.to(g.dtype))
    return Tensor(total)


def clip_grad_value_(parameters, clip_value):
    """Clip every gradient to [-clip_value, clip_value] in place."""
    if isinstance(parameters, Tensor):
        parameters = [parameters]
    for p in parameters:
        if p._data.grad is not None:
            p._data.grad.clamp_(-clip_value, clip_value)


def parameters_to_vector(parameters, name=None):
    """The parameters flattened and concatenated."""
    from ... import ops
    return ops.concat([ops.reshape(p, [-1]) for p in parameters], axis=0)


def vector_to_parameters(vec, parameters, name=None):
    """The slices of ``vec`` copied into the parameters, in order."""
    offset = 0
    data = vec._data
    for p in parameters:
        n = p._data.numel()
        p.set_value(data[offset:offset + n].reshape(p._data.shape))
        offset += n


def _norm_except(a: torch.Tensor, dim: int) -> torch.Tensor:
    dims = tuple(i for i in range(a.dim()) if i != dim)
    return torch.sqrt((a.float() ** 2).sum(dim=dims, keepdim=True)).to(
        a.dtype)


def weight_norm(layer, name="weight", dim=0):
    """Reparameterize ``layer.<name>`` as ``<name>_g * <name>_v /
    ||<name>_v||`` (the norm over every dim but ``dim``), recomputed by a
    forward pre-hook before each call."""
    from ..parameter import Parameter
    w = getattr(layer, name)
    if w is None:
        raise ValueError(f"layer has no parameter {name!r}")
    data = w._data.detach()
    del layer._parameters[name]
    layer.add_parameter(name + "_g", Parameter(_norm_except(data, dim)))
    layer.add_parameter(name + "_v", Parameter(data.clone()))

    def compute(layer_, inputs=None):
        v = getattr(layer_, name + "_v")
        g = getattr(layer_, name + "_g")
        normed = dispatch.call("weight_norm", lambda va, ga: ga * va / (
            _norm_except(va, dim) + 1e-12), [v, g])
        object.__setattr__(layer_, name, normed)

    compute(layer)
    hook = layer.register_forward_pre_hook(
        lambda layer_, inputs: compute(layer_))
    layer._weight_norm_hooks = getattr(layer, "_weight_norm_hooks", {})
    layer._weight_norm_hooks[name] = hook
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold g * v / ||v|| back into one parameter and drop the hook."""
    from ..parameter import Parameter
    hook = getattr(layer, "_weight_norm_hooks", {}).pop(name, None)
    if hook is None:
        raise ValueError(f"no weight_norm applied to parameter {name!r}")
    hook.remove()
    w = getattr(layer, name)
    if name in layer.__dict__:
        del layer.__dict__[name]
    del layer._parameters[name + "_g"]
    del layer._parameters[name + "_v"]
    layer.add_parameter(name, Parameter(w._data.detach()))
    return layer


__all__ = ["clip_grad_norm_", "clip_grad_value_", "parameters_to_vector",
           "vector_to_parameters", "weight_norm", "remove_weight_norm"]
