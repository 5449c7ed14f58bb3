"""The port's Paddle-API ops against the JAX package's.

``tests/test_ops.py``'s cases, each run on ``paddle_tpu`` and
``paddle_tpu_torch`` over the same numpy-seeded fp32 inputs: outputs to
RTOL/ATOL, and where the JAX case checks a gradient, the port's
``backward`` gradients against the JAX package's tape.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from torch_paddle_api import assert_same, run_both

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def rand(*shape, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


def check(fn, *arrays, grad=False, rtol=RTOL, atol=ATOL):
    j, t, jin, tin = run_both(fn, *arrays, stop_gradient=not grad)
    assert_same(j, t, rtol, atol)
    if grad:
        for pkg_out in (j, t):
            outs = pkg_out if isinstance(pkg_out, (list, tuple)) else [pkg_out]
            loss = outs[0].sum()
            for o in outs[1:]:
                loss = loss + o.sum()
            loss.backward()
        for a, b in zip(jin, tin):
            if a.grad is None or b.grad is None:    # an unused input
                assert a.grad is None and b.grad is None
            else:
                assert_same(a.grad, b.grad, rtol, atol)


@pytest.mark.parametrize("name", ["exp", "tanh", "sqrt", "abs", "sigmoid",
                                  "log", "sin", "cos", "floor", "ceil",
                                  "square", "rsqrt", "erf", "neg"])
def test_unary(name):
    x = rand(3, 4)
    if name in ("sqrt", "log", "rsqrt"):
        x = np.abs(x) + 0.5
    check(lambda p, a: getattr(p, name)(a), x,
          grad=name not in ("floor", "ceil", "abs"))


@pytest.mark.parametrize("name", ["add", "subtract", "multiply", "divide",
                                  "maximum", "minimum", "atan2", "pow"])
def test_binary(name):
    x, y = rand(3, 4), rand(3, 4, seed=1) + 2.0
    check(lambda p, a, b: getattr(p, name)(a, b), x, y, grad=True)


def test_broadcasting():
    check(lambda p, a, b: p.add(a, b), rand(3, 1, 4), rand(2, 1, seed=1),
          grad=True)


@pytest.mark.parametrize("tx,ty", [(False, False), (True, False),
                                   (False, True)])
def test_matmul(tx, ty):
    x = rand(4, 3) if tx else rand(3, 4)
    y = rand(5, 4, seed=1) if ty else rand(4, 5, seed=1)
    check(lambda p, a, b: p.matmul(a, b, transpose_x=tx, transpose_y=ty),
          x, y, grad=True)


def test_matmul_batched_transpose():
    check(lambda p, a, b: p.matmul(a, b, transpose_y=True), rand(2, 3, 4),
          rand(2, 5, 4, seed=1), grad=True)


@pytest.mark.parametrize("case", ["sum", "sum_axis", "mean_keep", "max",
                                  "min", "prod", "std", "var", "amax"])
def test_reductions(case):
    fns = {"sum": lambda p, a: p.sum(a),
           "sum_axis": lambda p, a: p.sum(a, axis=1),
           "mean_keep": lambda p, a: p.mean(a, axis=[0, 2], keepdim=True),
           "max": lambda p, a: p.max(a, axis=1),
           "min": lambda p, a: a.min(axis=-1),
           "prod": lambda p, a: p.prod(a, axis=0),
           "std": lambda p, a: p.std(a, axis=1),
           "var": lambda p, a: p.var(a, axis=[1, 2], unbiased=False),
           "amax": lambda p, a: p.amax(a, axis=2, keepdim=True)}
    check(fns[case], rand(3, 4, 5), grad=case not in ("max", "min", "amax"))


def test_cumsum_logsumexp():
    check(lambda p, a: p.cumsum(a, axis=1), rand(3, 4), grad=True)
    check(lambda p, a: p.logsumexp(a, axis=1), rand(3, 4), grad=True)


@pytest.mark.parametrize("case", ["reshape", "transpose", "flatten",
                                  "squeeze_unsqueeze", "flip", "tile",
                                  "expand", "concat", "stack", "split",
                                  "split_sections", "roll"])
def test_manipulation(case):
    fns = {"reshape": lambda p, a, b: p.reshape(a, [6, 4]),
           "transpose": lambda p, a, b: p.transpose(a, [2, 0, 1]),
           "flatten": lambda p, a, b: p.flatten(a, start_axis=1),
           "squeeze_unsqueeze": lambda p, a, b: p.squeeze(
               p.unsqueeze(a, [0, 2]), 0),
           "flip": lambda p, a, b: p.flip(a, axis=1),
           "tile": lambda p, a, b: p.tile(a, [1, 2, 1]),
           "expand": lambda p, a, b: p.expand(a[:, :1], [2, 3, 4]),
           "concat": lambda p, a, b: p.concat([a, b], axis=0),
           "stack": lambda p, a, b: p.stack([a, b], axis=1),
           "split": lambda p, a, b: p.split(a, 2, axis=2),
           "split_sections": lambda p, a, b: p.split(a, [1, -1], axis=1),
           "roll": lambda p, a, b: p.roll(a, 1, axis=2)}
    check(fns[case], rand(2, 3, 4), rand(2, 3, 4, seed=1), grad=True)


def test_gather_scatter_index():
    idx = np.array([0, 2, 4])
    for fn in (lambda p, a: p.gather(a, p.to_tensor(idx)),
               lambda p, a: p.index_select(a, p.to_tensor(idx), axis=0),
               lambda p, a: p.masked_fill(a, a > 0, 0.5),
               lambda p, a: p.take_along_axis(
                   a, p.to_tensor(np.array([[0], [2], [1], [0], [2]])), 1)):
        check(fn, rand(5, 3), grad=True)


def test_where_topk_argmax():
    x = rand(4, 5)
    check(lambda p, a: p.argmax(a, axis=1), x)
    check(lambda p, a: list(p.topk(a, k=2, axis=1)), x)
    cond = x > 0
    check(lambda p, a: p.where(p.to_tensor(cond), a, a * 2), x, grad=True)


def test_creation_ops():
    for p in (jp, tp):
        assert p.zeros([2, 3]).shape == [2, 3]
        assert p.ones([2], dtype="int32").dtype == p.int32
    for fn in (lambda p: p.arange(0, 10, 2), lambda p: p.eye(3),
               lambda p: p.full([2, 2], 7.0),
               lambda p: p.zeros_like(p.ones([4])),
               lambda p: p.linspace(0, 1, 5), lambda p: p.ones([2, 3]),
               lambda p: p.tril(p.ones([3, 3])),
               lambda p: p.full_like(p.ones([2]), 3.0)):
        assert_same(fn(jp), fn(tp))


def test_random_ops_reproducible():
    tp.seed(123)
    a = tp.randn([3, 3])
    tp.seed(123)
    b = tp.randn([3, 3])
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    u = tp.uniform([1000], min=0.0, max=1.0)
    assert 0 <= u.numpy().min() and u.numpy().max() <= 1
    r = tp.randint(0, 10, [100])
    assert r.numpy().min() >= 0 and r.numpy().max() < 10


def test_linalg_ops():
    x = rand(3, 3)
    spd = x @ x.T + 3 * np.eye(3, dtype=np.float32)
    check(lambda p, a: p.inverse(a), spd, rtol=1e-4)
    check(lambda p, a: p.cholesky(a), spd, rtol=1e-4)
    check(lambda p, a: p.trace(a), x)
    check(lambda p, a: p.norm(a), x, grad=True)
    check(lambda p, a: p.norm(a, p=1, axis=1), x)


def test_einsum():
    check(lambda p, a, b: p.einsum("bij,bjk->bik", a, b), rand(2, 3, 4),
          rand(2, 4, 5, seed=1), grad=True)


def test_cast_dtype_promotion():
    outs = [p.to_tensor([1, 2], dtype="int32") + p.to_tensor([0.5, 0.5])
            for p in (jp, tp)]
    assert_same(*outs)
    outs = [p.to_tensor([1, 2], dtype="int32") * 2.5 for p in (jp, tp)]
    assert_same(*outs)
    outs = [p.to_tensor([1.0, 2.0], dtype="bfloat16") * 2.0
            for p in (jp, tp)]
    assert_same(*outs)


TOPK_TIES = {
    # ROADMAP Queue 3's cases: lax.top_k puts the lower index first
    "largest": (np.array([1, 3, 3, 2, 3], np.float32), dict(k=3)),
    "smallest": (np.array([2, 1, 1, 3, 1], np.float32),
                 dict(k=2, largest=False)),
    "unsorted_is_sorted": (np.array([1, 0, 2, 5, 7, 7, 5], np.float32),
                           dict(k=3, sorted=False)),
    "axis0": (np.array([[1, 2, 2], [3, 2, 0], [3, 1, 2], [0, 2, 2]],
                       np.float32), dict(k=2, axis=0)),
    "axis0_smallest": (np.array([[1, 2, 2], [3, 2, 0], [1, 1, 2],
                                 [0, 2, 0]], np.float32),
                       dict(k=3, axis=0, largest=False)),
    "rows_last_axis": (np.array([[4, 4, 4, 1], [0, 5, 5, 5]], np.float32),
                       dict(k=2)),
}


@pytest.mark.parametrize("case", sorted(TOPK_TIES))
def test_topk_ties(case):
    """Values, int64 indices (int32 in JAX's x64-off mode) and the values'
    gradient on tied inputs (a weighted cotangent, so that it shows which
    tied element each rank took)."""
    x, kw = TOPK_TIES[case]
    check(lambda p, a: list(p.topk(a, **kw)), x)

    def weighted_values(p, a):
        v, _ = p.topk(a, **kw)
        w = np.arange(1, v.size + 1, dtype=np.float32).reshape(v.shape)
        return v * p.to_tensor(w)
    check(weighted_values, x, grad=True)
    _, idx = tp.topk(tp.to_tensor(x), **kw)
    assert idx.dtype == tp.int64


@pytest.mark.parametrize("case", ["all", "axis", "keepdim", "bool",
                                  "method", "int_2d_axis_list"])
def test_mean_of_integers(case):
    """An integer or bool mean is the float32 mean, as jnp.mean's."""
    ints = np.array([[1, 2, 4], [3, 6, 7]])
    fn, x = {
        "all": (lambda p, a: p.mean(a), np.array([1, 2])),
        "axis": (lambda p, a: p.mean(a, axis=1), ints),
        "keepdim": (lambda p, a: p.mean(a, axis=0, keepdim=True), ints),
        "bool": (lambda p, a: p.mean(a), np.array([True, False, True])),
        "method": (lambda p, a: a.mean(), ints),
        "int_2d_axis_list": (lambda p, a: p.mean(a, axis=[0, 1]),
                             ints.astype(np.int32)),
    }[case]
    check(fn, x)
    out = fn(tp, tp.to_tensor(x))
    assert out.dtype == tp.float32
    if case == "all":
        assert float(out.numpy()) == 1.5
