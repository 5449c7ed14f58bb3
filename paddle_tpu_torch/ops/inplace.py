"""In-place op variants, the trailing-underscore API (counterpart of
``paddle_tpu/ops/inplace.py``).

"In place" means the input Tensor takes over the base op's output: its
payload becomes the result's (``Tensor._swap_payload``), and with it the
result's autograd history, so a backward from a later use runs through
the op, as the JAX package's ``_adopt`` hands over the grad node. The
wrapper stays the identity. Under ``to_static``'s recording the swap
follows the recorder's rule for payload changes: allowed on a tensor
the call made, a graph break on an argument, a parameter or a buffer.

The random fills (``normal_``, ``bernoulli_``, ``log_normal_``,
``cauchy_``, ``geometric_``, and ``exponential_``, which the JAX registry
files under creation) draw from the tensor's device generator
and cut the autograd history: an initializer, not an op. A tensor that
took a gradient before keeps taking one (a new leaf), and a parameter's
payload is written into, as ``set_value`` does, so an optimizer holding
it sees the draw.

``INPLACE_OF`` is the JAX package's table (name -> base op); ``SUGAR``
adds the Tensor methods the port binds without a registry entry
(``add_``, ``scale_``, ...), made by the same factory.
"""
from __future__ import annotations

import math as _math

import torch

from ..core.generator import default_generator
from ..core.tensor import Tensor, as_tensor, graph_break
from .registry import OPS, register

#: in-place name -> base op name (a registered op)
INPLACE_OF = {
    n + "_": n for n in """
    addmm cumsum cumprod logit equal cos tan logical_and less_than
    floor_divide remainder floor_mod logical_or bitwise_and bitwise_or
    bitwise_xor bitwise_not less_equal triu sin mod abs tril pow acos
    expm1 sinh neg lgamma gammaincc gammainc square divide gammaln atan
    gcd lcm cast greater_equal erf greater_than tanh transpose flatten
    multiply logical_not scatter log log2 log10 trunc frac digamma
    renorm nan_to_num index_add index_put ldexp i0 polygamma copysign
    bitwise_left_shift bitwise_right_shift masked_fill masked_scatter
    hypot sinc multigammaln index_fill""".split()
}
INPLACE_OF["t_"] = "t"

#: Tensor methods that are in-place forms of ops (no registry entry)
SUGAR = {n + "_": n for n in """add subtract scale clip exp sqrt rsqrt
    floor ceil reciprocal round""".split()}

RANDOM_FILLS = ["normal_", "bernoulli_", "log_normal_", "cauchy_",
                "geometric_", "exponential_"]

__all__ = sorted(INPLACE_OF) + RANDOM_FILLS + ["where_"]


def adopt(x: Tensor, out: Tensor) -> Tensor:
    """x takes over out's payload and autograd history."""
    x._swap_payload(out._data)
    if not (out._data.is_floating_point() or out._data.is_complex()):
        x._int_stop_gradient = out.stop_gradient
    return x


def _make_inplace(name: str, base_name: str):
    def fn(x, *args, **kwargs):
        # looked up per call: some bases register after this module
        return adopt(x, OPS[base_name].lowering(x, *args, **kwargs))

    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = f"In-place ``{base_name}``: x takes over its result."
    return fn


for _n, _b in INPLACE_OF.items():
    globals()[_n] = register(_n, category="inplace")(_make_inplace(_n, _b))
for _n, _b in SUGAR.items():
    globals()[_n] = _make_inplace(_n, _b)


@register("where_", category="inplace")
def where_(condition, x, y, name=None):
    """In-place ``where``: the result goes into x (not the condition)."""
    from .search import where
    return adopt(x, where(condition, x, y))


# ----------------------------------------------------------- random fills
def _fill(x, draw) -> Tensor:
    """x filled with ``draw(shape, generator, device)`` in x's dtype."""
    graph_break("a random in-place fill")
    x = as_tensor(x)
    d = x._data
    with torch.no_grad():
        new = draw(tuple(d.shape), default_generator(d.device),
                   d.device).to(d.dtype)
    if d.requires_grad and d.is_leaf:
        with torch.no_grad():
            d.copy_(new)
        return x
    if d.requires_grad:
        new.requires_grad_(True)
    x._swap_payload(new)
    return x


@register("normal_", category="inplace", differentiable=False)
def normal_(x, mean=0.0, std=1.0, name=None):
    """Fill x with N(mean, std^2) draws."""
    return _fill(x, lambda s, g, dev: torch.randn(
        s, generator=g, device=dev) * std + mean)


@register("bernoulli_", category="inplace", differentiable=False)
def bernoulli_(x, p=0.5, name=None):
    """Fill x with Bernoulli(p) zeros and ones."""
    return _fill(x, lambda s, g, dev: (torch.rand(
        s, generator=g, device=dev) < p).float())


@register("log_normal_", category="inplace", differentiable=False)
def log_normal_(x, mean=1.0, std=2.0, name=None):
    """Fill x with exp(N(mean, std^2)) draws."""
    return _fill(x, lambda s, g, dev: torch.exp(torch.randn(
        s, generator=g, device=dev) * std + mean))


@register("cauchy_", category="inplace", differentiable=False)
def cauchy_(x, loc=0.0, scale=1.0, name=None):
    """Fill x with Cauchy(loc, scale) draws."""
    return _fill(x, lambda s, g, dev: torch.tan(_math.pi * (torch.rand(
        s, generator=g, device=dev) - 0.5)) * scale + loc)


@register("geometric_", category="inplace", differentiable=False)
def geometric_(x, probs, name=None):
    """Fill x with Geometric(probs) draws: the trial of the first success,
    from 1."""
    def draw(s, g, dev):
        u = torch.rand(s, generator=g, device=dev).clamp_min(
            torch.finfo(torch.float32).tiny)
        return torch.ceil(torch.log(u) / _math.log1p(-probs))
    return _fill(x, draw)


@register("exponential_", category="creation", differentiable=False)
def exponential_(x, lam=1.0, name=None):
    """Fill x with Exponential(lam) draws."""
    return _fill(x, lambda s, g, dev: torch.empty(s, device=dev).exponential_(
        lam, generator=g))
