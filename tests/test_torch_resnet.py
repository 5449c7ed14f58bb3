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
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.models import load_jax_layer_state
from torch_paddle_api import assert_grads

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


def _state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _pair(depth, seed=0):
    """The JAX model and its port twin on the JAX model's weights."""
    jp.seed(seed)
    j = getattr(jp.vision.models, f"resnet{depth}")(num_classes=10)
    with tp.device_guard("cpu"):
        t = getattr(tp.vision.models, f"resnet{depth}")(num_classes=10)
        load_jax_layer_state(t, _state(j))
    return j, t


_RUNS = {}


def _trained(depth):
    """Each package's model after one train-mode forward and backward of
    the cross-entropy loss: (pair, logits, losses), computed once."""
    if depth not in _RUNS:
        j, t = _pair(depth)
        x, y = _batch()
        out = []
        for pkg, m in ((jp, j), (tp, t)):
            m.train()
            logits = m(pkg.to_tensor(x))
            loss = pkg.nn.functional.cross_entropy(logits, pkg.to_tensor(y))
            loss.backward()
            out.append((np.asarray(logits.numpy()), float(loss.numpy())))
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
    j.eval()
    t.eval()
    np.testing.assert_allclose(t(tp.to_tensor(x)).numpy(),
                               np.asarray(j(jp.to_tensor(x)).numpy()),
                               rtol=0, atol=TOL[depth]["logits"])


def test_resnet18_adamw_three_steps():
    """Three AdamW steps (lr 1e-3, weight decay 0.01): the losses within
    1e-4 and the final logits within 1e-3."""
    j, t = _pair(18, seed=1)
    x, y = _batch(seed=2)
    losses = {}
    for pkg, m in ((jp, j), (tp, t)):
        m.train()
        opt = pkg.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                                  parameters=m.parameters())
        xs, ys = pkg.to_tensor(x), pkg.to_tensor(y)
        out = []
        for _ in range(3):
            loss = pkg.nn.functional.cross_entropy(m(xs), ys)
            loss.backward()
            opt.step()
            opt.clear_grad()
            out.append(float(loss.numpy()))
        m.eval()
        losses[pkg.__name__] = (out, np.asarray(m(xs).numpy()))
    (lj, oj), (lt, ot) = losses["paddle_tpu"], losses["paddle_tpu_torch"]
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-4)
    assert lt[-1] < lt[0]
    np.testing.assert_allclose(ot, oj, rtol=0, atol=1e-3)


def test_pretrained_raises():
    for pkg in (jp, tp):
        with pytest.raises(NotImplementedError):
            pkg.vision.models.resnet18(pretrained=True)
