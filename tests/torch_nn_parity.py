"""Shared helpers of the nn-slice parity tests: numpy-seeded inputs;
``check``, which runs one function on both packages' Paddle API and
compares the outputs and the input gradients; ``pair``, a JAX layer and
a port layer on the same weights; ``layer_grads``, a JAX layer's
outputs and parameter gradients.

The JAX side runs as one jitted program (``jax.value_and_grad`` of the
same Paddle-API calls, the payloads traced), as ``bench.py`` runs the
JAX package: eagerly, each of its ops compiles on its own and each
gradient again, seconds a case. Under the trace the JAX dispatcher runs
every lowering inline, so the arithmetic is the eager path's; what
eager dispatch alone does, leaving an input its op marks as taking no
gradient without one, the port's ``None`` gradient stands for (those
are not compared). A function that reads a tensor on the host (a shape
from the data) runs eagerly (``jit=False``)."""
import jax
import jax.numpy as jnp
import numpy as np

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.core.tensor import Tensor as JTensor
from torch_paddle_api import assert_same

RTOL, ATOL = 1e-5, 1e-5
GRAD_RTOL = 1e-4


def _x(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _ints(seed, high, *shape):
    return np.random.RandomState(seed).randint(0, high, shape).astype(
        np.int64)


def _weights(shape):
    return np.asarray(np.random.RandomState(99).randn(*shape), np.float32)


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [y for x in out for y in _leaves(x)]
    return [out]


def _grads(p, fn, arrays, diff):
    """Eagerly: the outputs and the gradients of sum(first output * w)
    with respect to the ``diff`` inputs."""
    ts = [p.to_tensor(a, stop_gradient=not d) for a, d in zip(arrays, diff)]
    out = fn(p, *ts)
    first = _leaves(out)[0]
    if any(diff):
        (first * p.to_tensor(_weights(first.shape))).sum().backward()
    return out, [t.grad for t, d in zip(ts, diff) if d]


def _jax_jit(fn, arrays, diff):
    """``_grads`` on the JAX package, as one jitted program."""
    xs = [jp.to_tensor(a)._data for a in arrays]
    idx = [i for i, d in enumerate(diff) if d]

    def run(d_arrays):
        ins = list(xs)
        for i, a in zip(idx, d_arrays):
            ins[i] = a
        leaves = _leaves(fn(jp, *[JTensor(a) for a in ins]))
        first = leaves[0]._data
        loss = jnp.sum(first * _weights(first.shape)) if idx else 0.0
        return loss, [None if t is None else t._data for t in leaves]

    (_, outs), grads = jax.jit(jax.value_and_grad(run, has_aux=True))(
        [xs[i] for i in idx])
    return ([None if o is None else JTensor(o) for o in outs],
            [JTensor(g) for g in grads])


def check(fn, *arrays, diff=None, rtol=RTOL, atol=ATOL, jit=True):
    """``fn(package, *tensors)`` on both packages; ``diff`` marks the
    inputs whose gradients are compared (default: the float ones)."""
    if diff is None:
        diff = [a.dtype == np.float32 for a in arrays]
    j_out, j_g = (_jax_jit(fn, arrays, diff) if jit
                  else _grads(jp, fn, arrays, diff))
    t_out, t_g = _grads(tp, fn, arrays, diff)
    assert_same([o for o in _leaves(j_out) if o is not None],
                [o for o in _leaves(t_out) if o is not None],
                rtol=rtol, atol=atol)
    for gj, gt in zip(j_g, t_g):
        if gt is None:          # an input the op takes no gradient of
            assert jit or gj is None
            continue
        gj, gt = np.asarray(gj.numpy(), np.float64), gt.numpy()
        err = np.linalg.norm(gt - gj) / max(np.linalg.norm(gj), 1e-30)
        assert err <= GRAD_RTOL, err


def layer_grads(layer, run, *arrays):
    """A JAX layer's outputs (leaves of ``run(layer, *tensors)``) and the
    gradient of sum(leaf * w) over the leaves (w numpy-seeded, in
    order) for each parameter, in ``named_parameters`` order, as one
    jitted program; ``port_layer_grads`` is the port's side."""
    params = [p for _, p in layer.named_parameters()]
    xs = [jp.to_tensor(a)._data for a in arrays]

    def f(pa):
        saved = [p._data for p in params]
        for p, a in zip(params, pa):
            p._data = a
        try:
            leaves = _leaves(run(layer, *[JTensor(a) for a in xs]))
        finally:
            for p, a in zip(params, saved):
                p._data = a
        rng = np.random.RandomState(3)
        loss = sum(jnp.sum(t._data * np.asarray(rng.randn(*t.shape),
                                                np.float32))
                   for t in leaves)
        return loss, [t._data for t in leaves]

    (_, outs), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        [p._data for p in params])
    return ([JTensor(o) for o in outs],
            [np.asarray(g, np.float64) for g in grads])


def jax_forward(layers, run, *arrays):
    """The leaves of ``run(*tensors)`` over the JAX ``layers``' current
    weights, as one jitted program (no host read may happen inside)."""
    params = [p for layer in layers for _, p in layer.named_parameters()]
    xs = [jp.to_tensor(a)._data for a in arrays]

    def f(pa):
        saved = [p._data for p in params]
        for p, a in zip(params, pa):
            p._data = a
        try:
            return [t._data for t in _leaves(run(*[JTensor(a) for a in xs]))]
        finally:
            for p, a in zip(params, saved):
                p._data = a
    return [np.asarray(o) for o in jax.jit(f)([p._data for p in params])]


def port_layer_grads(layer, run, *arrays):
    """``layer_grads`` on the port's layer, eagerly; a parameter that
    takes no gradient (``stop_gradient``) gives None, and every other
    must have one."""
    leaves = _leaves(run(layer, *[tp.to_tensor(a) for a in arrays]))
    rng = np.random.RandomState(3)
    loss = sum((t * tp.to_tensor(np.asarray(rng.randn(*t.shape),
                                            np.float32))).sum()
               for t in leaves)
    if not loss.stop_gradient:
        loss.backward()
    grads = []
    for name, p in layer.named_parameters():
        assert p.stop_gradient or p.grad is not None, name
        grads.append(None if p.stop_gradient else
                     p.grad.numpy().astype(np.float64))
    return leaves, grads


def assert_layer_grads(j_grads, t_grads, names, rtol=GRAD_RTOL,
                       key_bias_rel=1e-3):
    """Each trainable parameter's gradient norm-wise within ``rtol`` (a
    None from ``port_layer_grads``: one that takes none); a key
    projection's bias (zero in exact arithmetic) below ``key_bias_rel``
    of the largest gradient norm, as ``torch_paddle_api.assert_grads``
    holds it."""
    largest = max([np.linalg.norm(g) for g in j_grads] + [0.0])
    for name, gj, gt in zip(names, j_grads, t_grads):
        if gt is None:
            continue
        if name.endswith("k_proj.bias"):
            assert max(np.abs(gj).max(), np.abs(gt).max()) \
                <= key_bias_rel * largest, name
            continue
        err = np.linalg.norm(gt - gj) / max(np.linalg.norm(gj), 1e-30)
        assert err <= rtol, (name, err)


def pair(build, seed=0):
    """(JAX layer, port layer) of ``build(package)`` on the port's seeded
    weights. The JAX layer is built under its ``LazyGuard`` (its
    initializers compile per shape, eagerly, seconds a stack) and takes
    the port's arrays; ``load_jax_layer_state`` then carries the JAX
    layer's state back into the port, as it carries a trained JAX
    layer's."""
    import jax.numpy as jnp
    from paddle_tpu.nn import lazy_init
    from paddle_tpu_torch.models import load_jax_layer_state
    with tp.device_guard("cpu"):
        tp.seed(seed)
        port = build(tp)
    with lazy_init.LazyGuard():
        jax_layer = build(jp)
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    for name, p in jax_layer.named_parameters():
        p._swap_payload(jnp.asarray(state[name]))
        if hasattr(p, "_lazy_init"):
            del p._lazy_init                # materialized: no init runs
        lazy_init._PENDING.pop(id(p), None)
    for name, b in jax_layer.named_buffers():
        b._swap_payload(jnp.asarray(state[name]))
    with tp.device_guard("cpu"):
        load_jax_layer_state(port, {k: np.asarray(v.numpy()) for k, v in
                                    jax_layer.state_dict().items()})
    return jax_layer, port
