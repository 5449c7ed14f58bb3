"""The port's in-place family (``ops/inplace.py``) against the JAX
package's: every name of ``INPLACE_OF`` run on its base op's sweep
recipe on both packages (the written tensor's values, to the recipe's
tolerance, and the call returning that tensor), which tensor keeps the
autograd link and what its gradient is, ``where_``, an in-place op under
``to_static``, and the random fills (their moments against the JAX
package's, to MOMENT_TOL, and the same draws under one port seed)."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
import test_op_sweep as S
from paddle_tpu.ops.inplace import INPLACE_OF as JAX_INPLACE_OF
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu_torch.core.tensor import GraphBreak
from paddle_tpu_torch.ops.inplace import INPLACE_OF
from paddle_tpu_torch.ops.registry import OPS as POPS

#: sample moments of 200k draws against the JAX package's
MOMENT_TOL = 0.05


@pytest.fixture(autouse=True)
def _cpu():
    # the JAX package's global key stream goes back as it was, so the
    # draws here leave the tests after this file with the same stream
    state = jp.get_rng_state()
    with tp.device_guard("cpu"):
        yield
    jp.set_rng_state(state)


def test_same_table_as_the_jax_package():
    assert INPLACE_OF == JAX_INPLACE_OF
    for name in list(INPLACE_OF) + ["where_", "normal_", "bernoulli_",
                                    "log_normal_", "cauchy_", "geometric_"]:
        assert POPS[name].category == JOPS[name].category == "inplace"
        assert callable(getattr(tp.Tensor, name))


def _recipe_args(pkg, spec):
    args = []
    for v in spec["inputs"]:
        if isinstance(v, np.ndarray):
            args.append(pkg.to_tensor(np.copy(v)))
        elif isinstance(v, (list, tuple)) and all(
                isinstance(x, np.ndarray) for x in v):
            args.append([pkg.to_tensor(np.copy(x)) for x in v])
        else:
            args.append(v)
    return args


@pytest.mark.parametrize("name", sorted(INPLACE_OF))
def test_inplace_matches_jax(name):
    base = INPLACE_OF[name]
    spec = S.R[base]
    outs = []
    for pkg, ops in ((jp, JOPS), (tp, POPS)):
        args = _recipe_args(pkg, spec)
        x = args[0]
        got = ops[name].lowering(*args, **spec["attrs"])
        assert got is x
        outs.append((x, ops[base].lowering(*_recipe_args(pkg, spec),
                                           **spec["attrs"])))
    (jx, jbase), (px, pbase) = outs
    tol = dict(rtol=max(spec["rtol"], 1e-5), atol=max(spec["atol"], 1e-6))
    np.testing.assert_allclose(px.numpy(), np.asarray(jx.numpy()), **tol)
    assert list(px.shape) == list(jbase.shape) == list(pbase.shape)


def _grad_case(pkg, method, *args):
    w = pkg.to_tensor(np.array([0.3, -0.7, 1.1], np.float32),
                      stop_gradient=False)
    y = w * 2.0
    # the JAX Tensor binds only the arithmetic sugar as methods
    fn = getattr(pkg.Tensor, method, None) or (JOPS if pkg is jp
                                               else POPS)[method].lowering
    out = fn(y, *args)
    assert out is y
    (y * y).sum().backward()
    return y.numpy(), w.grad.numpy(), y.stop_gradient


@pytest.mark.parametrize("method,args", [("exp_", ()), ("tanh_", ()),
                                         ("abs_", ()), ("square_", ()),
                                         ("scale_", (3.0,)),
                                         ("add_", (1.5,)),
                                         ("clip_", (-1.0, 1.0))])
def test_inplace_keeps_the_grad_link(method, args):
    """The written tensor carries the op's autograd history: a backward
    from it reaches w through the in-place op."""
    jy, jg, jsg = _grad_case(jp, method, *args)
    py, pg, psg = _grad_case(tp, method, *args)
    np.testing.assert_allclose(py, np.asarray(jy), rtol=1e-6)
    np.testing.assert_allclose(pg, np.asarray(jg), rtol=1e-5)
    assert jsg is psg is False


def test_where_writes_into_x():
    outs = []
    for pkg, ops in ((jp, JOPS), (tp, POPS)):
        c = pkg.to_tensor(np.array([True, False, True]))
        x = pkg.to_tensor(np.array([1.0, 2.0, 3.0], np.float32))
        y = pkg.to_tensor(np.array([9.0, 8.0, 7.0], np.float32))
        assert ops["where_"].lowering(c, x, y) is x
        outs.append((x.numpy(), c.numpy()))
    np.testing.assert_allclose(outs[1][0], np.asarray(outs[0][0]))
    np.testing.assert_array_equal(outs[1][1], [True, False, True])


def test_inplace_under_to_static():
    """On a tensor the call made, an in-place op is recorded and replayed
    (the values as the JAX package's); on an argument it is a graph break
    (the replay would not write it)."""
    outs = []
    for pkg in (jp, tp):
        def f(x):
            y = x * 2.0
            y.exp_()
            y.add_(1.0)
            return y
        st = pkg.jit.to_static(f, full_graph=True)
        outs.append([st(pkg.to_tensor(np.array([v, -v], np.float32))).numpy()
                     for v in (0.1, 0.5, 0.1)])
        assert st.graph_break_reason is None
    np.testing.assert_allclose(np.asarray(outs[1]), np.asarray(outs[0]),
                               rtol=1e-6)

    def g(x):
        x.exp_()
        return x
    with pytest.raises(GraphBreak, match="in-place"):
        tp.jit.to_static(g, full_graph=True)(
            tp.to_tensor(np.ones(2, np.float32)))


FILLS = [("normal_", dict(mean=1.0, std=2.0)), ("bernoulli_", dict(p=0.3)),
         ("log_normal_", dict(mean=0.1, std=0.25)),
         ("cauchy_", dict(loc=0.5, scale=1.0)),
         ("geometric_", dict(probs=0.4)), ("exponential_", dict(lam=2.0))]


def _moments(name, a):
    a = np.asarray(a, np.float64).ravel()
    if name == "cauchy_":           # no mean: its median and quartiles
        return np.percentile(a, [25, 50, 75])
    return np.array([a.mean(), a.std()])


@pytest.mark.parametrize("name,kw", FILLS)
def test_random_fill_moments_and_seed(name, kw):
    n = 200_000
    jx = jp.to_tensor(np.zeros(n, np.float32))
    JOPS[name].lowering(jx, **kw)
    tp.seed(11)
    px = tp.to_tensor(np.zeros(n, np.float32))
    assert getattr(px, name)(**kw) is px
    np.testing.assert_allclose(_moments(name, px.numpy()),
                               _moments(name, jx.numpy()), rtol=MOMENT_TOL,
                               atol=MOMENT_TOL)
    tp.seed(11)
    again = tp.to_tensor(np.zeros(n, np.float32))
    getattr(again, name)(**kw)
    np.testing.assert_array_equal(again.numpy(), px.numpy())


def test_random_fill_of_a_parameter_keeps_its_payload():
    lin = tp.nn.Linear(4, 3)
    w = lin.weight
    payload = w._data
    w.normal_(0.0, 0.02)
    assert w._data is payload and not w.stop_gradient


@pytest.mark.parametrize("name,kw", FILLS)
def test_random_fill_of_a_parameter_still_trains(name, kw):
    """Every fill, exponential_ too, writes into a parameter: it keeps
    requiring a gradient, takes one, and its optimizer steps it."""
    lin = tp.nn.Linear(4, 3)
    w = lin.weight
    getattr(w, name)(**kw)
    drawn = w.numpy().copy()
    assert not w.stop_gradient and w._data.requires_grad
    opt = tp.optimizer.SGD(learning_rate=0.1, parameters=lin.parameters())
    lin(tp.to_tensor(np.ones((2, 4), np.float32))).sum().backward()
    assert w.grad is not None
    np.testing.assert_allclose(w.grad.numpy(), np.full((4, 3), 2.0))
    opt.step()
    np.testing.assert_allclose(w.numpy(), drawn - 0.2, rtol=1e-6, atol=1e-6)
