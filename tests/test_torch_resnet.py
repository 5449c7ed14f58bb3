"""The port's ResNet-18 and ResNet-50 against the JAX package's, on the
same weights (carried by ``models.load_jax_layer_state``) and the same
numpy-seeded batch: B=4, 3x64x64, 10 classes (``bench.py``'s small
ResNet size).

Held: the state dict's keys and shapes, the parameter count, the
train-mode logits and loss, every parameter's gradient, the running
statistics after a train-mode forward, the eval-mode forward, and three
AdamW steps of ResNet-18.

Tolerances. ResNet-18: logits 1e-4, gradients 1e-4 norm-wise. ResNet-50:
logits 1e-3, gradients 5e-2 norm-wise. Its deepest batch-norm
parameters take gradients of 0.04-1% of the largest; there the fp32
JAX model and the fp32 port are each 2-3% from a float64 run of the
port (both logits within 3.2e-4 of it), so the 16 bottleneck blocks'
fp32 rounding, not either package, sets that bound.

The JAX side runs each train-mode forward and backward, and each eval
forward, as one jitted program (``_jax_train``, ``_jax_eval``): eagerly,
every op of a ResNet compiles on its own. The weights are the port's
seeded ones, which the JAX model, built under ``LazyGuard``, takes
(``torch_vision_zoo.pair``; its initializers compile per shape).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.core.tensor import Tensor as JTensor
from torch_paddle_api import assert_grads
from torch_vision_zoo import pair

TOL = {18: dict(logits=1e-4, grads=1e-4, stats=1e-5),
       50: dict(logits=1e-3, grads=5e-2, stats=1e-4)}


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(4, 3, 64, 64).astype(np.float32),
            rng.randint(0, 10, 4))


def _pair(depth, seed=0):
    """The JAX model and its port twin on the same seeded weights."""
    return pair(f"resnet{depth}", seed=seed, num_classes=10)


def _rebound(model):
    params = [p for _, p in model.named_parameters()]
    return params, [b for _, b in model.named_buffers()]


def _jax_train(model):
    """The JAX model's train-mode forward and the cross entropy's
    backward as one jitted program: ``run(x, y)`` -> (logits, loss); it
    sets each parameter's ``grad`` and the running statistics the
    forward updated, as the eager step does."""
    params, bufs = _rebound(model)

    def step(pa, ba, xa, ya):
        saved = [t._data for t in params + bufs]
        for t, a in zip(params + bufs, list(pa) + list(ba)):
            t._data = a
        try:
            model.train()
            logits = model(JTensor(xa))
            loss = jp.nn.functional.cross_entropy(logits, JTensor(ya))
            return loss._data, (logits._data, [b._data for b in bufs])
        finally:
            for t, a in zip(params + bufs, saved):
                t._data = a
    fn = jax.jit(jax.value_and_grad(step, has_aux=True))

    def run(x, y):
        (loss, (logits, new_bufs)), grads = fn(
            [p._data for p in params], [b._data for b in bufs],
            jnp.asarray(x), jnp.asarray(y))
        for b, a in zip(bufs, new_bufs):
            b._data = a
        for p, g in zip(params, grads):
            p.grad = JTensor(g)
        return np.asarray(logits), float(loss)
    return run


def _jax_eval(model, x):
    """The JAX model's eval-mode forward as one jitted program."""
    params, bufs = _rebound(model)

    def fwd(arrays, xa):
        saved = [t._data for t in params + bufs]
        for t, a in zip(params + bufs, arrays):
            t._data = a
        try:
            model.eval()
            return model(JTensor(xa))._data
        finally:
            for t, a in zip(params + bufs, saved):
                t._data = a
    return np.asarray(jax.jit(fwd)([t._data for t in params + bufs],
                                   jnp.asarray(x)))


_RUNS = {}


def _trained(depth):
    """Each package's model after one train-mode forward and backward of
    the cross-entropy loss: (pair, logits, losses), computed once."""
    if depth not in _RUNS:
        j, t = _pair(depth)
        x, y = _batch()
        out = [_jax_train(j)(x, y)]
        t.train()
        logits = t(tp.to_tensor(x))
        loss = tp.nn.functional.cross_entropy(logits, tp.to_tensor(y))
        loss.backward()
        out.append((logits.numpy(), float(loss.numpy())))
        _RUNS[depth] = ((j, t), out)
    return _RUNS[depth]


@pytest.mark.parametrize("depth", [18, 50])
def test_state_dict_keys_and_shapes(depth):
    (j, t), _ = _trained(depth)
    js, ts = j.state_dict(), t.state_dict()
    assert list(ts) == list(js)
    assert all(list(ts[k].shape) == list(js[k].shape) for k in js)
    assert sum(p.size for p in t.parameters()) == \
        sum(p.size for p in j.parameters())


def test_resnet50_parameter_count():
    """1000 classes: 25,557,032 parameters, the reference's count (the
    JAX package's tests/test_models_hapi.py holds its own to it)."""
    assert sum(p.size for p in tp.vision.models.resnet50().parameters()) \
        == 25_557_032


@pytest.mark.parametrize("depth", [18, 50])
def test_train_forward_and_gradients(depth):
    (j, t), ((lj, loss_j), (lt, loss_t)) = _trained(depth)
    tol = TOL[depth]
    np.testing.assert_allclose(lt, lj, rtol=0, atol=tol["logits"])
    assert abs(loss_t - loss_j) <= tol["logits"]
    assert_grads(j, t, rtol=tol["grads"])


@pytest.mark.parametrize("depth", [18, 50])
def test_running_statistics_after_train_forward(depth):
    (j, t), _ = _trained(depth)
    jb = dict(j.named_buffers())
    tb = dict(t.named_buffers())
    assert list(tb) == list(jb)
    for k in jb:
        np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k].numpy()),
                                   rtol=0, atol=TOL[depth]["stats"],
                                   err_msg=k)


@pytest.mark.parametrize("depth", [18, 50])
def test_eval_forward(depth):
    """The running statistics of the train-mode forward normalize."""
    (j, t), _ = _trained(depth)
    x, _ = _batch(seed=1)
    t.eval()
    np.testing.assert_allclose(t(tp.to_tensor(x)).numpy(), _jax_eval(j, x),
                               rtol=0, atol=TOL[depth]["logits"])


def test_resnet18_adamw_three_steps():
    """Three AdamW steps (lr 1e-3, weight decay 0.01): the losses within
    1e-4 and the final logits within 1e-3."""
    j, t = _pair(18, seed=1)
    x, y = _batch(seed=2)
    opt = jp.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                             parameters=j.parameters())
    train = _jax_train(j)
    lj = []
    for _ in range(3):
        lj.append(train(x, y)[1])
        opt.step()
        opt.clear_grad()
    oj = _jax_eval(j, x)
    t.train()
    opt = tp.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                             parameters=t.parameters())
    xs, ys = tp.to_tensor(x), tp.to_tensor(y)
    lt = []
    for _ in range(3):
        loss = tp.nn.functional.cross_entropy(t(xs), ys)
        loss.backward()
        opt.step()
        opt.clear_grad()
        lt.append(float(loss.numpy()))
    t.eval()
    ot = t(xs).numpy()
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-4)
    assert lt[-1] < lt[0]
    np.testing.assert_allclose(ot, oj, rtol=0, atol=1e-3)


def test_pretrained_raises():
    for pkg in (jp, tp):
        with pytest.raises(NotImplementedError):
            pkg.vision.models.resnet18(pretrained=True)
