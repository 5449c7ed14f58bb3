"""Shared helpers of the vision-op parity tests
(``test_torch_vision_ops*.py``; not collected): inputs, the comparison
of both packages' outputs and gradients, and its tolerance (TOL: fp32 on
both sides; the port gathers and sums in another order than the JAX
masks and vmaps)."""
import numpy as np

import paddle_tpu as jp
import paddle_tpu.vision.ops as JO
import paddle_tpu_torch as tp
import paddle_tpu_torch.vision.ops as TO

TOL = dict(rtol=1e-5, atol=1e-5)


def np_(x):
    return np.asarray(x.numpy())


def rand_boxes(rng, n, span=60.0, size=(4.0, 20.0)):
    xy = rng.rand(n, 2) * span
    wh = size[0] + rng.rand(n, 2) * (size[1] - size[0])
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def assert_outs(j, t, exact_ints=True):
    js, ts = as_list(j), as_list(t)
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        a, b = np_(a), np_(b)
        assert a.shape == b.shape, (a.shape, b.shape)
        if np.issubdtype(a.dtype, np.integer) and exact_ints:
            np.testing.assert_array_equal(b.astype(np.int64),
                                          a.astype(np.int64))
        else:
            np.testing.assert_allclose(b, a, **TOL)


def grad_check(fn, arrays, diff):
    """fn(ops, pkg, *tensors) on both packages; values, then the
    gradients of sum(out * w) for the inputs flagged in ``diff``."""
    res = []
    for O, pkg in ((JO, jp), (TO, tp)):
        ts = [pkg.to_tensor(a, stop_gradient=not d)
              for a, d in zip(arrays, diff)]
        out = fn(O, pkg, *ts)
        outs = as_list(out)
        loss = None
        for i, o in enumerate(outs):
            w = np.random.RandomState(10 + i).randn(*o.shape).astype(
                np.float32)
            term = (o * pkg.to_tensor(w)).sum()
            loss = term if loss is None else loss + term
        loss.backward()
        res.append((outs, [np_(t.grad) for t, d in zip(ts, diff) if d]))
    (jo, jg), (to, tg) = res
    assert_outs(jo, to)
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(b, a, **TOL)


def rand_rois(seed, n, span, size):
    return rand_boxes(np.random.RandomState(seed), n, span, size)
