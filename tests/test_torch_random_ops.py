"""The random ops of this slice on the port against the JAX package.
The two RNGs never agree value for value, so each draw is held to the
JAX package's sample moments over 200k draws (to MOMENT_TOL), to its
shape and dtype kind, and to the same draws under one port seed:
``binomial``, ``standard_gamma``, ``log_normal``, ``bernoulli``,
``poisson``, ``multinomial``, ``randint_like``, ``shuffle_batch``,
``top_p_sampling`` and ``svd_lowrank``."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from torch_paddle_api import dtype_kind
from paddle_tpu.core.dtype import dtype_name as jax_dtype_name
from paddle_tpu_torch.core.dtype import dtype_name as port_dtype_name

MOMENT_TOL = 0.05
N = 200_000


@pytest.fixture(autouse=True)
def _cpu():
    state = jp.get_rng_state()
    with tp.device_guard("cpu"):
        yield
    jp.set_rng_state(state)


def _draw(p, name):
    rate = p.to_tensor(np.full(N, 3.0, np.float32))
    if name == "binomial":
        return p.binomial(p.to_tensor(np.full(N, 10.0, np.float32)),
                          p.to_tensor(np.full(N, 0.3, np.float32)))
    if name == "standard_gamma":
        return p.standard_gamma(rate)
    if name == "log_normal":
        return p.log_normal(0.1, 0.5, [N])
    if name == "bernoulli":
        return p.bernoulli(p.to_tensor(np.full(N, 0.3, np.float32)))
    if name == "poisson":
        return p.poisson(rate)
    if name == "multinomial":
        # one row: the JAX package's draw with replacement takes no batch
        # of rows (ROADMAP Queue 3)
        return p.multinomial(p.to_tensor(np.array([1.0, 2.0, 3.0, 4.0],
                                                  np.float32)), N,
                             replacement=True)
    if name == "randint_like":
        # an integer dtype: the JAX package's default (x's float dtype)
        # raises there (ROADMAP Queue 3)
        return p.randint_like(rate, 0, 7, dtype="int32")
    raise KeyError(name)


@pytest.mark.parametrize("name", ["binomial", "standard_gamma", "log_normal",
                                  "bernoulli", "poisson", "multinomial",
                                  "randint_like"])
def test_moments_and_seed(name):
    j = _draw(jp, name)
    tp.seed(5)
    t = _draw(tp, name)
    assert list(t.shape) == list(j.shape)
    assert dtype_kind(port_dtype_name(t.dtype)) == dtype_kind(
        jax_dtype_name(j.dtype))
    ja = np.asarray(j.numpy(), np.float64).ravel()
    ta = t.numpy().astype(np.float64).ravel()
    np.testing.assert_allclose([ta.mean(), ta.std()], [ja.mean(), ja.std()],
                               rtol=MOMENT_TOL, atol=MOMENT_TOL)
    tp.seed(5)
    np.testing.assert_array_equal(_draw(tp, name).numpy(), t.numpy())


def test_shuffle_batch():
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    j = jp.shuffle_batch(jp.to_tensor(x)).numpy()
    t = tp.shuffle_batch(tp.to_tensor(x), seed=4).numpy()
    for got in (np.asarray(j), t):            # a permutation of the rows
        np.testing.assert_array_equal(np.sort(got[:, 0]), x[:, 0])
        np.testing.assert_array_equal(got[:, 1], got[:, 0] + 1)
    np.testing.assert_array_equal(
        tp.shuffle_batch(tp.to_tensor(x), seed=4).numpy(), t)


def test_top_p_sampling():
    rng = np.random.RandomState(1)
    probs = rng.dirichlet(np.ones(12), size=6).astype(np.float32)
    ps = np.full(6, 0.7, np.float32)
    outs = []
    for p in (jp, tp):
        pr, ids = p.top_p_sampling(p.to_tensor(probs), p.to_tensor(ps),
                                   seed=3)
        outs.append((np.asarray(pr.numpy()), np.asarray(ids.numpy())))
        assert list(ids.shape) == [6, 1]
    for pr, ids in outs:           # each id lies in its row's nucleus
        for b in range(6):
            order = np.argsort(-probs[b], kind="stable")
            csum = np.cumsum(probs[b][order])
            nucleus = order[:int(np.searchsorted(csum, 0.7)) + 1]
            assert ids[b, 0] in nucleus
            np.testing.assert_allclose(pr[b, 0], probs[b, ids[b, 0]])
    pr2, ids2 = tp.top_p_sampling(tp.to_tensor(probs), tp.to_tensor(ps),
                                  seed=3)
    np.testing.assert_array_equal(ids2.numpy(), outs[1][1])


def test_svd_lowrank_finds_the_leading_values():
    rng = np.random.RandomState(2)
    a = (rng.randn(30, 4) @ rng.randn(4, 20)).astype(np.float32)
    want = np.linalg.svd(a, compute_uv=False)[:4]
    for p in (jp, tp):
        _u, s, _v = p.linalg.svd_lowrank(p.to_tensor(a), q=4)
        np.testing.assert_allclose(np.asarray(s.numpy()), want, rtol=1e-3)
