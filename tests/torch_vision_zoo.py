"""Shared helpers of the zoo parity tests (``test_torch_vision_zoo*.py``;
not collected): a JAX model and its port twin on the same weights, one
train-mode step and an eval forward on both, and the checks. The JAX
side runs them as one jitted program (``jax_step``).

Dropout is set to p = 0 in both models before the train-mode forward:
the two packages' generators never agree, and what dropout does is held
by the port's dropout tests. The loss is the cross entropy of the main
logits (GoogLeNet: plus 0.3 x each auxiliary head's, its training
recipe); a feature extractor's is its features' projection onto a
seeded random tensor.

Tolerances (fp32 on both sides): logits and loss LOGITS_TOL relative to
the largest logit; running statistics STATS_TOL; each parameter's
gradient norm-wise within GRAD_TOL of the larger of its own norm and
GRAD_FLOOR times the largest gradient's norm. The floor is there because
a batch-norm bias that feeds a convolution and another train-mode batch
norm (every projection of an inverted residual, every dense layer's
first norm) has a gradient of zero in exact arithmetic, and both
packages hold rounding noise there, 1e-7 to 1e-5 of the largest; and
all the gradients, as one vector, within GRAD_GLOBAL_TOL.

The deepest models (GoogLeNet, DenseNet-121, InceptionV3) run B8 and
take wider bounds, DEEP_TOLS: through their chains of train-mode batch
norms fp32 itself is far from exact. Against a float64 run of the port
(its batch norm and loss kept in float64) on the same weights and
batch, the fp32 port's and the fp32 JAX program's outputs are within
2.1e-4 of it, but their gradients are, at the worst parameter and as
one vector: GoogLeNet (64x64) 2.3e-2 / 1.5e-2 and 1.8e-2 / 1.4e-2,
DenseNet-121 (64x64) 1.2e-2 / 6.0e-3 and 1.2e-2 / 3.4e-3, InceptionV3
(107x107) 2.4e-2 / 1.8e-2 and 3.9e-2 / 3.0e-2
(``tests/torch_zoo_float64.py``; InceptionV3 at 75x75, the smallest
input it takes, normalizes two values a channel in its last blocks at
B2, and both are above 100% there).
"""
import jax
import jax.numpy as jnp
import numpy as np

import paddle_tpu as jp
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.nn import lazy_init
from paddle_tpu.nn.lazy_init import LazyGuard
import paddle_tpu_torch as tp
from paddle_tpu_torch.models import load_jax_layer_state

LOGITS_TOL = 1e-4
STATS_TOL = 1e-4
GRAD_TOL = 1e-3
GRAD_FLOOR = 1e-3
CLASSES = 7
GRAD_GLOBAL_TOL = 1e-3
#: the deep models' bounds (module docstring): (logits, each gradient,
#: all gradients as one vector)
DEEP_TOLS = (1e-3, 1e-1, 1e-1)


def _state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _no_dropout(model):
    for layer in model.sublayers():
        if type(layer).__name__ == "Dropout":
            layer.p = 0.0


def pair(name, seed=0, **kw):
    """(JAX model, port twin) on the same seeded weights, dropout off in
    both. The port's initializers make them: the JAX model is built
    under ``LazyGuard`` (its initializers compile per shape, eagerly,
    40 s a model) and takes the port's arrays; ``load_jax_layer_state``
    then carries the JAX model's state back into the port, as it carries
    a trained JAX model's."""
    with tp.device_guard("cpu"):
        tp.seed(seed)
        t = getattr(tp.vision.models, name)(**kw)
    j = lazy_twin(lambda: getattr(jp.vision.models, name)(**kw), t)
    with tp.device_guard("cpu"):
        load_jax_layer_state(t, _state(j))
    _no_dropout(j)
    _no_dropout(t)
    return j, t


def lazy_twin(build, port):
    """The JAX model ``build()`` makes under ``LazyGuard``, on the port
    model's weights (no JAX initializer runs)."""
    return lazy_jax(build, lambda j: _state(port))


def lazy_jax(build, state_of):
    """The JAX model ``build()`` makes under ``LazyGuard`` (its
    initializers would compile per shape), on the numpy arrays
    ``state_of(model)`` gives by state-dict key."""
    with LazyGuard():
        j = build()
    state = state_of(j)
    for n, p in j.named_parameters():
        p._swap_payload(jnp.asarray(state[n]))
        del p._lazy_init                       # materialized: no init runs
        lazy_init._PENDING.pop(id(p), None)
    for n, b in j.named_buffers():
        b._swap_payload(jnp.asarray(state[n]))
    return j


def batch(size, seed=0, n=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3, size, size).astype(np.float32),
            rng.randint(0, CLASSES, n))


def _loss(pkg, heads, y):
    """The cross entropy of the main head (plus 0.3 x each auxiliary
    head's), or a feature extractor's projection onto a seeded tensor."""
    if len(heads[0].shape) == 2:
        label = pkg.to_tensor(y)
        loss = pkg.nn.functional.cross_entropy(heads[0], label)
        for aux in heads[1:]:
            loss = loss + 0.3 * pkg.nn.functional.cross_entropy(aux, label)
        return loss
    r = np.random.RandomState(1).randn(*heads[0].shape).astype(np.float32)
    return (heads[0] * pkg.to_tensor(r)).sum()


def _heads(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def jax_step(model, x, y):
    """The JAX model's train step and then its eval forward as one jitted
    program: ``jax.value_and_grad`` of the loss with the parameters and
    buffers rebound to the traced arrays (as ``bench.py``'s steps run
    the JAX package; eagerly, every op of a zoo model would compile on
    its own, minutes a model), the eval forward reading the running
    statistics the step left. Returns (train heads, loss, eval heads,
    gradients in ``named_parameters`` order, buffers by name after the
    step)."""
    params = [p for _, p in model.named_parameters()]
    names = [n for n, _ in model.named_buffers()]
    bufs = [b for _, b in model.named_buffers()]

    def step(pa, ba, xa):
        saved = [t._data for t in params + bufs]
        for t, a in zip(params + bufs, list(pa) + list(ba)):
            t._data = a
        try:
            model.train()
            heads = _heads(model(JTensor(xa)))
            loss = _loss(jp, heads, y)
            new_bufs = [b._data for b in bufs]
            model.eval()
            ev = _heads(model(JTensor(xa)))
            return loss._data, ([h._data for h in heads],
                                [h._data for h in ev], new_bufs)
        finally:
            for t, a in zip(params + bufs, saved):
                t._data = a

    (loss, (heads, ev, new_bufs)), grads = jax.jit(jax.value_and_grad(
        step, has_aux=True))([p._data for p in params],
                             [b._data for b in bufs], jnp.asarray(x))
    for b, a in zip(bufs, new_bufs):
        b._data = a
    return ([np.asarray(h) for h in heads], float(loss),
            [np.asarray(h) for h in ev], [np.asarray(g) for g in grads],
            {n: np.asarray(b) for n, b in zip(names, new_bufs)})


def port_step(model, x, y):
    """The port's train step (eager) and eval forward, as ``jax_step``
    returns them."""
    model.train()
    heads = _heads(model(tp.to_tensor(x)))
    loss = _loss(tp, heads, y)
    loss.backward()
    loss = float(loss.numpy())
    model.eval()
    ev = _heads(model(tp.to_tensor(x)))
    return ([h.numpy() for h in heads], loss, [h.numpy() for h in ev],
            [None if p.grad is None else p.grad.numpy()
             for p in model.parameters()],
            {n: b.numpy() for n, b in model.named_buffers()})


def run(name, size, n=2, **kw):
    """Both models after a train step and an eval forward on one seeded
    batch of ``n``: (JAX model, port model, JAX results, port
    results)."""
    j, t = pair(name, **kw)
    x, y = batch(size, n=n)
    got_j = jax_step(j, x, y)
    with tp.device_guard("cpu"):
        got_t = port_step(t, x, y)
    return j, t, got_j, got_t


def assert_structure(j, t):
    """The same state-dict keys, in order, with the same shapes."""
    js, ts = j.state_dict(), t.state_dict()
    assert list(ts) == list(js)
    for k in js:
        assert list(ts[k].shape) == list(js[k].shape), k


def _close(a, b, tol):
    scale = max(float(np.abs(a).max()), 1.0)
    np.testing.assert_allclose(b, a, rtol=0, atol=tol * scale)


def assert_run(j, t, got_j, got_t, tols=(LOGITS_TOL, GRAD_TOL,
                                         GRAD_GLOBAL_TOL)):
    """Outputs of every head in train and eval mode, the loss, the
    running statistics and every gradient (module docstring)."""
    logits_tol, grad_tol, global_tol = tols
    (tr_j, loss_j, ev_j, g_js, st_j) = got_j
    (tr_t, loss_t, ev_t, g_ts, st_t) = got_t
    assert len(tr_j) == len(tr_t) and len(ev_j) == len(ev_t)
    for a, b in zip(tr_j + ev_j, tr_t + ev_t):
        assert a.shape == b.shape
        _close(a, b, logits_tol)
    assert abs(loss_t - loss_j) <= logits_tol * max(abs(loss_j), 1.0)
    assert list(st_t) == list(st_j)
    for k in st_j:
        _close(st_j[k], st_t[k], STATS_TOL)
    names = [n for n, _ in j.named_parameters()]
    assert len(g_ts) == len(g_js) == len(names)
    largest = max(np.linalg.norm(g) for g in g_js)
    for name, g_j, g_t in zip(names, g_js, g_ts):
        assert g_t is not None, name
        g_j, g_t = g_j.astype(np.float64), g_t.astype(np.float64)
        ref = max(np.linalg.norm(g_j), GRAD_FLOOR * largest)
        err = np.linalg.norm(g_t - g_j) / ref
        assert err <= grad_tol, (name, err)
    flat_j = np.concatenate([g.ravel() for g in g_js]).astype(np.float64)
    flat_t = np.concatenate([g.ravel() for g in g_ts]).astype(np.float64)
    err = np.linalg.norm(flat_t - flat_j) / np.linalg.norm(flat_j)
    assert err <= global_tol, err
