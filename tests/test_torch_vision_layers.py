"""The activations and the channel shuffle the vision zoo needs, against
the JAX package's: ``relu6``, ``swish``, ``hardswish``, ``hardsigmoid``
(default and custom slope/offset) and ``channel_shuffle`` (NCHW and
NHWC), as functionals and as layers (``ReLU6``, ``Swish``,
``Hardswish``, ``Hardsigmoid``), values and input gradients on
numpy-seeded inputs that straddle every kink (fp32, TOL); each is one op
through the dispatcher with a registry entry.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.ops.registry import OPS
from torch_paddle_api import assert_same, run_both

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def _x(shape=(4, 6, 3, 5), seed=0):
    # values in [-8, 8], none within 1e-3 of a kink (-3, 0, 3, 6)
    x = np.random.RandomState(seed).uniform(-8, 8, shape).astype(np.float32)
    for k in (-3.0, 0.0, 3.0, 6.0):
        near = np.abs(x - k) < 1e-3
        x[near] += 2e-3
    return x


FUNCS = {
    "relu6": lambda pkg, x: pkg.nn.functional.relu6(x),
    "swish": lambda pkg, x: pkg.nn.functional.swish(x),
    "hardswish": lambda pkg, x: pkg.nn.functional.hardswish(x),
    "hardsigmoid": lambda pkg, x: pkg.nn.functional.hardsigmoid(x),
    "hardsigmoid_custom": lambda pkg, x: pkg.nn.functional.hardsigmoid(
        x, slope=0.2, offset=0.4),
    "ReLU6": lambda pkg, x: pkg.nn.ReLU6()(x),
    "Swish": lambda pkg, x: pkg.nn.Swish()(x),
    "Hardswish": lambda pkg, x: pkg.nn.Hardswish()(x),
    "Hardsigmoid": lambda pkg, x: pkg.nn.Hardsigmoid()(x),
    "channel_shuffle": lambda pkg, x: pkg.nn.functional.channel_shuffle(
        x, 3),
    "channel_shuffle_nhwc": lambda pkg, x: pkg.nn.functional.channel_shuffle(
        x, 5, data_format="NHWC"),
}


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_value_and_grad(name):
    fn = FUNCS[name]
    j, t, jx, tx = run_both(lambda pkg, x: fn(pkg, x), _x(),
                            stop_gradient=False)
    assert_same(j, t, **TOL)
    w = np.random.RandomState(1).randn(*t.shape).astype(np.float32)
    (j * jp.to_tensor(w)).sum().backward()
    (t * tp.to_tensor(w)).sum().backward()
    np.testing.assert_allclose(tx[0].grad.numpy(),
                               np.asarray(jx[0].grad.numpy()), **TOL)


@pytest.mark.parametrize("op", ["relu6", "hardswish", "hardsigmoid",
                                "channel_shuffle"])
def test_registered(op):
    assert OPS[op].category in ("activation", "nn_common")
