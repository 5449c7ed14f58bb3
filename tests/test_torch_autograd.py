"""The port's autograd against the JAX package's.

``tests/test_autograd.py``'s cases and the autograd ones of
``tests/test_functional_autograd.py`` (jacobian, hessian, vjp, jvp and
the incubate ``Jacobian``/``Hessian``), each run on ``paddle_tpu`` and
``paddle_tpu_torch`` over the same inputs, gradients compared to
RTOL/ATOL; then the port's own cases: ``PyLayer`` under ``no_grad`` and
with two inputs, hooks that replace gradients, double backward of a
product chain, and ``paddle.grad``'s ``allow_unused``. (The dlpack and
hub cases of that file are not autograd; they wait for ``utils``.)
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.incubate import autograd as jiag
from paddle_tpu_torch.incubate import autograd as tiag
from torch_paddle_api import assert_same

RTOL, ATOL = 1e-5, 1e-6
PKGS = [pytest.param(jp, id="jax"), pytest.param(tp, id="port")]


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def both(fn):
    """``fn(package)`` on each package; the results compared."""
    j, t = fn(jp), fn(tp)
    assert_same(j, t, RTOL, ATOL)
    return j, t


def _leaf(p, vals):
    return p.to_tensor(np.asarray(vals, np.float32), stop_gradient=False)


# ------------------------------------------------------- test_autograd.py
def test_simple_backward():
    def run(p):
        x = _leaf(p, [2.0, 3.0])
        (x * x).sum().backward()
        return x.grad
    both(run)


def test_grad_accumulation():
    def run(p):
        x = _leaf(p, [1.0])
        (x * 2).sum().backward()
        (x * 3).sum().backward()
        g = x.grad.clone()
        x.clear_grad()
        assert x.grad is None
        return g
    j, _ = both(run)
    np.testing.assert_allclose(np.asarray(j.numpy()), [5.0])


def test_branching_graph():
    def run(p):
        x = _leaf(p, [1.0, 2.0])
        (x * 2 + x * 3).sum().backward()
        return x.grad
    both(run)


def test_chain_and_shared_subgraph():
    def run(p):
        x = _leaf(p, [0.5])
        h = p.tanh(x)
        (h * h).backward()
        return x.grad
    both(run)


def test_stop_gradient_blocks():
    def run(p):
        x = _leaf(p, [1.0])
        w = p.to_tensor([2.0])
        (x * w).sum().backward()
        assert w.grad is None
        return x.grad
    both(run)


@pytest.mark.parametrize("p", PKGS)
def test_no_grad_context(p):
    x = _leaf(p, [1.0])
    with p.no_grad():
        y = x * 2
    assert y.stop_gradient
    assert not (x * 2).stop_gradient


@pytest.mark.parametrize("p", PKGS)
def test_backward_twice_raises(p):
    x = _leaf(p, [1.0])
    y = (x * x).sum()
    y.backward()
    with pytest.raises(RuntimeError):
        y.backward()


def test_retain_graph():
    def run(p):
        x = _leaf(p, [3.0])
        y = (x * x).sum()
        y.backward(retain_graph=True)
        y.backward()
        return x.grad
    both(run)


def test_paddle_grad_api():
    def run(p):
        x = _leaf(p, [2.0])
        (gx,) = p.grad([x * x * x], [x])
        assert x.grad is None      # grad() must not touch .grad
        return gx
    both(run)


def test_double_backward():
    def run(p):
        x = _leaf(p, [2.0])
        (gx,) = p.grad([x * x * x], [x], create_graph=True)
        (ggx,) = p.grad([gx], [x])
        return [gx, ggx]
    j, _ = both(run)
    np.testing.assert_allclose(np.asarray(j[1].numpy()), [12.0])


def test_tensor_hook():
    def run(p):
        x = _leaf(p, [1.0])
        seen = []
        h = x * 2
        h.register_hook(lambda g: seen.append(g.numpy().copy()))
        h.sum().backward()
        assert len(seen) == 1
        return p.to_tensor(seen[0])
    both(run)


def test_hook_replaces_grad():
    def run(p):
        x = _leaf(p, [1.0])
        y = x * 2
        y.register_hook(lambda g: g * 10)
        y.sum().backward()
        return x.grad
    both(run)


def test_retain_grads_non_leaf():
    def run(p):
        x = _leaf(p, [1.0])
        y = x * 2
        y.retain_grads()
        (y * 3).sum().backward()
        return [y.grad, x.grad]
    both(run)


def test_backward_with_grad_tensor():
    def run(p):
        x = _leaf(p, [1.0, 2.0])
        (x * 2).backward(p.to_tensor([1.0, 10.0]))
        return x.grad
    both(run)


def _cube(p):
    class Cube(p.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x * x

        @staticmethod
        def backward(ctx, grad):
            (x,) = ctx.saved_tensor()
            return grad * 3 * x * x
    return Cube


def test_pylayer_custom():
    def run(p):
        x = _leaf(p, [2.0])
        y = _cube(p).apply(x)
        y.sum().backward()
        return [y, x.grad]
    both(run)


# ------------------------------------------- test_functional_autograd.py
def test_jacobian_diag_square():
    def run(p):
        x = _leaf(p, [1.0, 2.0, 3.0])
        J = p.autograd.jacobian(x * x, x)
        assert tuple(J.shape) == (3, 3)
        return J[:]
    both(run)


def test_jacobian_full_matrix():
    W = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    x0 = np.random.RandomState(1).randn(4).astype(np.float32)

    def run(p):
        x = _leaf(p, x0)
        return p.autograd.jacobian(p.matmul(p.to_tensor(W), x).tanh(), x)[:]
    both(run)


def test_jacobian_batched():
    xb = np.random.RandomState(2).randn(5, 3)

    def run(p):
        x = _leaf(p, xb)
        J = p.autograd.jacobian(x * x, x, batch_axis=0)
        assert tuple(J.shape) == (5, 3, 3)
        return J[:]
    both(run)


def test_jacobian_tuple_nesting():
    def run(p):
        x, z = _leaf(p, [1.0, 2.0]), _leaf(p, [3.0])
        Js = p.autograd.jacobian(x * x, (x, z))
        assert isinstance(Js, tuple) and len(Js) == 2
        return [Js[0][:], Js[1][:]]
    both(run)


def test_jacobian_single_row_is_lazy():
    def run(p):
        x = _leaf(p, [1.0, 2.0, 3.0])
        J = p.autograd.jacobian(x * x, x)
        row = J[1]
        assert len(J._rows) == 1
        return row
    both(run)


def test_hessian_cubic_and_cross_terms():
    def run(p):
        x = _leaf(p, [0.5, -1.0, 2.0])
        s = x[0] * x[1] * x[2] + (x * x * x).sum()
        return p.autograd.hessian(s, x)[:]
    both(run)


@pytest.mark.parametrize("p", PKGS)
def test_hessian_nonscalar_rejected(p):
    x = _leaf(p, [1.0, 2.0])
    with pytest.raises(ValueError):
        p.autograd.hessian(x * x, x)


def test_hessian_tuple_xs_cross_blocks():
    def run(p):
        x, z = _leaf(p, [1.0, 2.0]), _leaf(p, [3.0])
        s = (x * x).sum() + x.sum() * z.sum()
        H = p.autograd.hessian(s, (x, z))
        return [H[i][k][:] for i in range(2) for k in range(2)]
    both(run)


def test_vjp():
    def run(p):
        iag = jiag if p is jp else tiag
        xs = p.to_tensor(np.array([1.0, 3.0], np.float32))
        v = p.to_tensor(np.array([2.0, 0.5], np.float32))
        ys, g = iag.vjp(lambda a: a * a, xs, v)
        return [ys, g]
    both(run)


def test_jvp_equals_forward_mode():
    def run(p):
        iag = jiag if p is jp else tiag
        xs = p.to_tensor(np.array([0.3, -1.2, 2.0], np.float32))
        v = p.to_tensor(np.array([1.0, 0.5, -2.0], np.float32))
        return iag.jvp(lambda a: (a * a).sum() * a, xs, v)[1]
    both(run)


def test_incubate_jacobian_and_hessian_classes():
    def run(p):
        iag = jiag if p is jp else tiag
        x = p.to_tensor(np.array([1.0, 2.0], np.float32))
        z = p.to_tensor(np.array([3.0], np.float32))
        J = iag.Jacobian(lambda a: a * a, x)
        H = iag.Hessian(lambda a, b: (a * a).sum() + a.sum() * b.sum(),
                        (x, z))
        assert tuple(J.shape) == (2, 2) and tuple(H.shape) == (3, 3)
        return [J[:], H[:]]
    both(run)


def test_vjp_unused_input_zero_filled_and_flags_untouched():
    def run(p):
        iag = jiag if p is jp else tiag
        x = p.to_tensor(np.array([1.0, 2.0], np.float32))
        z = p.to_tensor(np.array([5.0], np.float32))
        _, grads = iag.vjp(lambda a, b: a * a, (x, z),
                           p.to_tensor(np.ones(2, np.float32)))
        assert x.stop_gradient and z.stop_gradient
        return list(grads)
    both(run)


# ------------------------------------------------------ the port's own
def test_pylayer_under_no_grad_records_nothing():
    x = _leaf(tp, [2.0])
    with tp.no_grad():
        y = _cube(tp).apply(x)
    assert y.stop_gradient and x.grad is None
    np.testing.assert_allclose(y.numpy(), [8.0])


def test_pylayer_two_inputs_and_a_frozen_one():
    class MulAdd(tp.PyLayer):
        @staticmethod
        def forward(ctx, a, b, scale):
            ctx.save_for_backward(a, b)
            ctx.scale = scale
            return a * b * scale

        @staticmethod
        def backward(ctx, g):
            a, b = ctx.saved_tensor()
            return g * b * ctx.scale, g * a * ctx.scale

    a, b = _leaf(tp, [1.0, 2.0]), tp.to_tensor([3.0, 4.0])
    MulAdd.apply(a, b, 2.0).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), [6.0, 8.0])
    assert b.grad is None


def test_double_backward_through_a_product_chain():
    def run(p):
        x = _leaf(p, [0.5, -1.5])
        y = (p.tanh(x) * x).sum()
        (g,) = p.grad([y], [x], create_graph=True)
        (gg,) = p.grad([g.sum()], [x])
        return [g, gg]
    both(run)


@pytest.mark.parametrize("p", PKGS)
def test_grad_allow_unused(p):
    x, z = _leaf(p, [1.0]), _leaf(p, [2.0])
    with pytest.raises(RuntimeError):
        p.grad([x * 2], [x, z], retain_graph=True)
    gx, gz = p.grad([x * 2], [x, z], allow_unused=True)
    assert gz is None
    np.testing.assert_allclose(np.asarray(gx.numpy()), [2.0])


def test_hook_handle_removes():
    x = _leaf(tp, [1.0])
    y = x * 2
    h = y.register_hook(lambda g: g * 10)
    h.remove()
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [2.0])
