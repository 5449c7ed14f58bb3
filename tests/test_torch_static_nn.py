"""The port's ``static.nn`` layer helpers and ``ExponentialMovingAverage``
against the JAX package's (the cases of ``tests/test_round4b.py``'s
``TestStaticNN`` and ``TestEMA``).

Programs are built in both packages, the port program on the JAX
program's parameters (``models.load_jax_program_state``), and run on the
same numpy-seeded feeds; eager calls take the same inputs and weights.
fp32 within TOL (atol and rtol 1e-5).

``batch_norm(is_test=False)``'s running statistics: after the build both
packages hold the update of the build's example batch (zeros). A run of
the port's program updates them again, from the run's batch (the op
updates them as it normalizes); a run of the JAX package's program
leaves them as the build left them (its update is outside the recorded
op, ROADMAP Queue 3). So the port's are held, run by run, to the JAX
package's formula (momentum 0.9, unbiased batch variance) over the
batch statistics of the JAX program's fetched input of the norm.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.models import load_jax_layer_state
from test_torch_static_program import build_both, rand, run_both

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def test_conv_bn_layer_norm_build_and_run():
    def build(pkg):
        x = pkg.static.data("x", [None, 1, 8, 8], "float32")
        h = pkg.static.nn.conv2d(x, 4, 3, padding=1, act="relu")
        h = pkg.static.nn.batch_norm(h)
        h = h.flatten(start_axis=1)
        h = pkg.static.nn.layer_norm(h, begin_norm_axis=1)
        return [pkg.static.nn.fc(h, 3)]
    j, t = build_both(build, seed=3)
    for b in (2, 5):
        (o,) = run_both(j, t, {"x": rand(b, b, 1, 8, 8)})
        assert o.shape == (b, 3) and np.isfinite(o).all()


def test_static_lenet_end_to_end():
    """BASELINE ladder config 1 from static.nn primitives, at two batches
    of one program."""
    def build(pkg):
        F = pkg.nn.functional
        img = pkg.static.data("img", [None, 1, 28, 28], "float32")
        c1 = pkg.static.nn.conv2d(img, 6, 5, padding=2, act="relu")
        c2 = pkg.static.nn.conv2d(F.max_pool2d(c1, 2, 2), 16, 5, act="relu")
        flat = F.max_pool2d(c2, 2, 2).flatten(start_axis=1)
        f1 = pkg.static.nn.fc(flat, 120, activation="relu")
        f2 = pkg.static.nn.fc(f1, 84, activation="relu")
        return [pkg.static.nn.fc(f2, 10)]
    j, t = build_both(build, seed=5)
    for b in (4, 3):
        (o,) = run_both(j, t, {"img": rand(b, b, 1, 28, 28)})
        assert o.shape == (b, 10)


def recorded(monkeypatch, name):
    """Record the ``nn.<name>`` layers each package's layer helpers make:
    {package: [layers]}."""
    made = {}
    for pkg in (jp, tp):
        made[pkg] = []

        class Recorded(getattr(pkg.nn, name)):
            def __init__(self, *a, _made=made[pkg], **k):
                super().__init__(*a, **k)
                _made.append(self)
        monkeypatch.setattr(pkg.nn, name, Recorded)
    return made


def test_instance_and_spectral_norm(monkeypatch):
    """Eager instance norm on the same input; spectral norm in a program,
    the power iteration's start vectors (drawn by each package's
    generator) carried from the JAX layer."""
    xv = rand(0, 2, 3, 5, 5)
    got = tp.static.nn.instance_norm(tp.to_tensor(xv)).numpy()
    want = np.asarray(jp.static.nn.instance_norm(jp.to_tensor(xv)).numpy())
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got.reshape(2, 3, -1).mean(-1), 0.0,
                               atol=1e-4)
    made = recorded(monkeypatch, "SpectralNorm")
    progs = []
    for pkg in (jp, tp):
        main = pkg.static.Program()
        with pkg.static.program_guard(main):
            w = pkg.static.data("w", [6, 4], "float32")
            progs.append((main, [pkg.static.nn.spectral_norm(
                w, power_iters=20)]))
    (jl,), (tl,) = made[jp], made[tp]
    load_jax_layer_state(tl, {k: np.asarray(v.numpy())
                              for k, v in jl.state_dict().items()})
    (wn,) = run_both(*progs, {"w": rand(1, 6, 4)})
    assert abs(np.linalg.svd(wn, compute_uv=False)[0] - 1.0) < 1e-2


def _py_func_case(pkg):
    x = pkg.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    x.stop_gradient = False
    template = pkg.to_tensor(np.zeros((2, 3), np.float32))
    out = pkg.static.nn.py_func(lambda a: a * 3.0, x, template,
                                backward_func=lambda g: g * 3.0)
    out.sum().backward()
    return np.asarray(out.numpy()), np.asarray(x.grad.numpy())


def test_py_func_forward_and_backward():
    got, want = _py_func_case(tp), _py_func_case(jp)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(got[1], np.full((2, 3), 3.0, np.float32))
    with pytest.raises(NotImplementedError):
        tp.static.nn.py_func(lambda a: a, got[0], got[0],
                             skip_vars_in_backward_input=[got[0]])


def test_py_func_in_a_program_runs_on_every_run():
    calls = []

    def host(a):
        calls.append(a.shape)
        return np.sort(a, axis=-1)

    def build(pkg):
        x = pkg.static.data("x", [3, 4], "float32")
        template = pkg.to_tensor(np.zeros((3, 4), np.float32))
        return [pkg.static.nn.py_func(host, x * 2.0, template) + 1.0]
    j, t = build_both(build)
    calls.clear()
    xv = rand(7, 3, 4)
    for _ in range(2):
        (o,) = run_both(j, t, {"x": xv})
    np.testing.assert_allclose(o, np.sort(xv * 2.0, axis=-1) + 1.0, **TOL)
    assert calls.count((3, 4)) == 4     # each package's two runs


def _ema_run(pkg, state, decay, steps=3, thres_steps=None):
    m = pkg.nn.Linear(4, 2)
    m.set_state_dict(state)
    ema = pkg.static.ExponentialMovingAverage(
        decay=decay, thres_steps=thres_steps, parameters=m.parameters())
    opt = pkg.optimizer.SGD(learning_rate=0.1, parameters=m.parameters())
    for i in range(steps):
        (m(pkg.to_tensor(rand(i, 3, 4))) ** 2).mean().backward()
        opt.step()
        opt.clear_grad()
        ema.update()
    return m, ema


def test_ema_shadow_average_matches_jax_and_hand_rolled():
    jp.seed(7)
    state = {k: np.asarray(v.numpy())
             for k, v in jp.nn.Linear(4, 2).state_dict().items()}
    jm, jema = _ema_run(jp, state, 0.9)
    tm, tema = _ema_run(tp, state, 0.9)
    live = tm.weight.numpy().copy()
    with jema.apply(), tema.apply():
        np.testing.assert_allclose(tm.weight.numpy(),
                                   np.asarray(jm.weight.numpy()), **TOL)
        np.testing.assert_allclose(tm.bias.numpy(),
                                   np.asarray(jm.bias.numpy()), **TOL)
    np.testing.assert_allclose(tm.weight.numpy(), live)      # restored
    # thres_steps ramps the decay: min(decay, (1 + t) / (10 + t))
    jm, jema = _ema_run(jp, state, 0.999, thres_steps=True)
    tm, tema = _ema_run(tp, state, 0.999, thres_steps=True)
    with jema.apply(), tema.apply():
        np.testing.assert_allclose(tm.weight.numpy(),
                                   np.asarray(jm.weight.numpy()), **TOL)


def test_ema_apply_without_restore():
    jp.seed(7)
    state = {k: np.asarray(v.numpy())
             for k, v in jp.nn.Linear(4, 2).state_dict().items()}
    jm, jema = _ema_run(jp, state, 0.5, steps=1)
    tm, tema = _ema_run(tp, state, 0.5, steps=1)
    trained = tm.weight.numpy().copy()
    for ema in (jema, tema):
        with ema.apply(need_restore=False):
            pass
    # the shadows stay applied, the payload the optimizer holds too
    np.testing.assert_allclose(tm.weight.numpy(),
                               np.asarray(jm.weight.numpy()), **TOL)
    assert not np.allclose(tm.weight.numpy(), trained)
    with pytest.raises(RuntimeError, match="already applied"):
        tema.apply()
    for ema in (jema, tema):
        ema.restore()
    np.testing.assert_allclose(tm.weight.numpy(), trained)
    np.testing.assert_allclose(tm.weight.numpy(),
                               np.asarray(jm.weight.numpy()), **TOL)


def test_batch_norm_running_statistics_after_build_and_runs(monkeypatch):
    norms = recorded(monkeypatch, "BatchNorm")

    def build(pkg):
        # the build's batch is zeros: its statistics are the conv bias,
        # the same constant in both packages
        bias = pkg.ParamAttr(initializer=pkg.nn.initializer.Constant(0.3))
        x = pkg.static.data("x", [None, 2, 4, 4], "float32")
        h = pkg.static.nn.conv2d(x, 3, 3, padding=1, bias_attr=bias)
        return [h, pkg.static.nn.batch_norm(h, act="relu")]
    j, t = build_both(build, seed=4)
    (jn,), (tn,) = norms[jp], norms[tp]

    def stats(bn):
        return [np.asarray(b.numpy()) for b in (bn._mean, bn._variance)]
    built = stats(jn)
    np.testing.assert_allclose(built[0], 0.03, **TOL)
    for g, w in zip(stats(tn), built):
        np.testing.assert_allclose(g, w, **TOL)
    want = [s.copy() for s in built]
    for k in range(2):
        h, _ = run_both(j, t, {"x": rand(30 + k, 5, 2, 4, 4)})
        n = h.size // h.shape[1]
        mean = h.mean(axis=(0, 2, 3))
        var = h.var(axis=(0, 2, 3)) * n / (n - 1)
        want = [0.9 * want[0] + 0.1 * mean, 0.9 * want[1] + 0.1 * var]
        for g, w in zip(stats(tn), want):
            np.testing.assert_allclose(g, w, **TOL)
        for g, w in zip(stats(jn), built):       # the JAX program's
            np.testing.assert_array_equal(g, w)


def test_batch_norm_is_test_keeps_the_statistics():
    def build(pkg):
        x = pkg.static.data("x", [None, 2, 4, 4], "float32")
        return [pkg.static.nn.batch_norm(x, is_test=True)]
    j, t = build_both(build)
    for k in range(2):
        run_both(j, t, {"x": rand(40 + k, 3, 2, 4, 4)})


def test_sparse_embedding_waits_for_the_parameter_server():
    with pytest.raises(NotImplementedError, match="distributed/ps"):
        tp.static.nn.sparse_embedding(None, [10, 4])


def test_static_nn_names_and_forwarding():
    assert tp.static.nn.__all__ == jp.static.nn.__all__
    assert tp.static.nn.fc is tp.static.nn.common.fc
    assert tp.static.nn.cond is tp.static.nn.control_flow.cond
    with pytest.raises(AttributeError):
        tp.static.nn.no_such_layer_helper


def test_embedding_in_a_program_takes_the_layer_weights():
    """A Layer built before the guard is captured live: its weights
    carried by ``load_jax_layer_state`` give the JAX program's output."""
    jl = jp.nn.Embedding(10, 4)
    tl = tp.nn.Embedding(10, 4)
    load_jax_layer_state(tl, {k: np.asarray(v.numpy())
                              for k, v in jl.state_dict().items()})

    def build(pkg):
        ids = pkg.static.data("ids", [None, 3], "int64")
        return [(jl if pkg is jp else tl)(ids).sum(axis=-1)]
    run_both(*build_both(build), {"ids": np.array([[1, 2, 3], [4, 5, 9]])})
