"""The port's Paddle-API Tensor against the JAX package's.

``tests/test_tensor.py``'s cases (all but ``test_dist_placement_api``:
``to_dist`` is a later slice), each run on ``paddle_tpu`` and
``paddle_tpu_torch`` with the same inputs and held to the same results
(exact: these are small integers and halves), plus the port's own
contract: the payload is a ``torch.Tensor`` on the current device, and
``stop_gradient`` is its ``requires_grad``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from torch_paddle_api import assert_same, dtype_kind, jax_dtype_name
from paddle_tpu_torch.core.dtype import dtype_name


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


@pytest.mark.parametrize("data", [[1.0, 2.0, 3.0], np.arange(4),
                                  [True, False], 3.5,
                                  np.ones(3, np.float64), [[1, 2], [3, 4]]],
                         ids=["floats", "np_int64", "bools", "scalar",
                              "np_float64", "nested_ints"])
def test_to_tensor_dtypes(data):
    j, t = jp.to_tensor(data), tp.to_tensor(data)
    assert dtype_name(t.dtype) == jax_dtype_name(j.dtype)
    # integer data lands as int32, as in the JAX package
    assert t.dtype in (torch.float32, torch.int32, torch.bool)
    assert isinstance(t._data, torch.Tensor) and t._data.device.type == "cpu"


def test_shape_meta():
    for pkg in (jp, tp):
        t = pkg.zeros([2, 3, 4])
        assert t.shape == [2, 3, 4]
        assert t.ndim == 3
        assert t.size == 24
        assert t.numel() == 24
        assert len(t) == 2


def test_item_and_numpy():
    for pkg in (jp, tp):
        t = pkg.to_tensor(3.5)
        assert t.item() == pytest.approx(3.5)
        assert float(t) == pytest.approx(3.5)
        a = pkg.to_tensor([[1, 2], [3, 4]])
        np.testing.assert_array_equal(a.numpy(), [[1, 2], [3, 4]])


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "pow", "radd",
                                "neg", "rsub", "rdiv", "floordiv", "mod"])
def test_arithmetic_operators(op):
    fns = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
           "mul": lambda a, b: a * b, "div": lambda a, b: b / a,
           "pow": lambda a, b: a ** 2, "radd": lambda a, b: 2 + a,
           "neg": lambda a, b: -a, "rsub": lambda a, b: 1.5 - a,
           "rdiv": lambda a, b: 3.0 / b, "floordiv": lambda a, b: b // a,
           "mod": lambda a, b: b % a}
    outs = [fns[op](pkg.to_tensor([1.0, 2.0]), pkg.to_tensor([3.0, 4.0]))
            for pkg in (jp, tp)]
    assert_same(*outs, rtol=0, atol=0)


def test_comparison_and_indexing():
    outs = []
    for pkg in (jp, tp):
        a = pkg.to_tensor([[1.0, 2.0], [3.0, 4.0]])
        m = a > 2.0
        assert dtype_kind(dtype_name(m.dtype) if pkg is tp
                          else jax_dtype_name(m.dtype)) == "bool"
        outs.append((a[0], a[:, 1], a[m], a[-1, ::-1], a[None, 1]))
    for j, t in zip(*outs):
        assert_same(j, t, rtol=0, atol=0)


def test_setitem():
    outs = []
    for pkg in (jp, tp):
        a = pkg.zeros([3, 3])
        a[1] = 5.0
        a[0, 0] = 7.0
        a[2, 1:] = pkg.to_tensor([1.0, 2.0])
        outs.append(a)
    assert_same(*outs, rtol=0, atol=0)


def test_set_value_and_inplace():
    outs = []
    for pkg in (jp, tp):
        a = pkg.ones([2, 2])
        a.set_value(np.full((2, 2), 3.0, np.float32))
        b = a.clone()
        a.add_(pkg.ones([2, 2]))
        c = a.clone()
        a.zero_()
        outs.append((b, c, a))
    for j, t in zip(*outs):
        assert_same(j, t, rtol=0, atol=0)
    assert float(outs[1][1].numpy()[0, 0]) == 4.0


def test_astype_cast():
    for pkg in (jp, tp):
        a = pkg.to_tensor([1.5, 2.5])
        b = a.astype("int32")
        assert b.dtype == pkg.int32
        c = a.astype(pkg.bfloat16)
        assert c.dtype == pkg.bfloat16
    np.testing.assert_array_equal(
        tp.to_tensor([1.5, 2.5]).astype("int32").numpy(),
        np.asarray(jp.to_tensor([1.5, 2.5]).astype("int32").numpy()))


def test_detach_and_clone():
    for pkg in (jp, tp):
        a = pkg.to_tensor([1.0], stop_gradient=False)
        b = (a * 2).detach()
        assert b.stop_gradient
        c = a.clone()
        assert not c.stop_gradient  # clone is differentiable


def test_stop_gradient_is_the_payloads_requires_grad():
    a = tp.to_tensor([1.0, 2.0])
    assert a.stop_gradient and not a._data.requires_grad
    a.stop_gradient = False
    assert a._data.requires_grad and a.is_leaf
    y = a * 3
    assert not y.stop_gradient and not y.is_leaf
    y.stop_gradient = True            # cuts the graph at y, as Paddle does
    assert not y._data.requires_grad
    ids = tp.to_tensor([1, 2], stop_gradient=False)   # torch cannot
    assert not ids.stop_gradient and not ids._data.requires_grad


def test_bf16_numpy_comes_back_as_float32():
    t = tp.to_tensor([1.5, -2.0], dtype="bfloat16")
    assert t.dtype == tp.bfloat16
    arr = t.numpy()
    assert arr.dtype == np.float32
    np.testing.assert_array_equal(arr, [1.5, -2.0])


def test_to_tensor_place_and_torch_input():
    src = torch.arange(3.0)
    t = tp.to_tensor(src, stop_gradient=False)
    assert t._data.requires_grad and not src.requires_grad
    assert t.place == tp.CPUPlace(0)
    assert tp.get_device() == "cpu"
