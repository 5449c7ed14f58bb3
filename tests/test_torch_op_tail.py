"""The ops the sweep's SKIP list sends to dedicated suites, held against
the JAX package on numpy-seeded inputs: ``where(condition)`` and
``nonzero``, ``unique``/``unique_consecutive`` with their extra outputs,
the linalg tail (``inv``, ``cholesky_inverse``, ``matrix_exp``,
``vector_norm``, ``matrix_norm``, ``cond``, ``ormqr``, ``lu_unpack``,
``pca_lowrank``), ``histogramdd``, ``as_strided``, ``combinations``,
``frexp``, quantiles, the quantization ops through the registry,
``rotary_embedding``'s entry, and the top-level names of this slice.
Float results to 1e-5 (1e-4 for the decompositions), integral ones
equal."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu_torch.ops.registry import OPS as POPS
from torch_paddle_api import assert_same


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def run(name, *arrays, tol=1e-5, **kw):
    """Op ``name`` on both packages over the same arrays; the outputs
    agree (shapes, dtype kinds, values)."""
    outs = []
    for pkg, ops in ((jp, JOPS), (tp, POPS)):
        args = [pkg.to_tensor(a) if isinstance(a, np.ndarray) else a
                for a in arrays]
        out = ops[name].lowering(*args, **kw)
        outs.append(list(out) if isinstance(out, (list, tuple)) else [out])
    assert_same(outs[0], outs[1], rtol=tol, atol=tol)
    return outs[1]


MASKS = [np.array([True, False, True, True]),
         np.random.RandomState(0).rand(3, 4) > 0.5,
         np.random.RandomState(1).rand(2, 3, 4) > 0.5,
         np.zeros((2, 3), bool), np.ones((2, 2, 2), bool)]


@pytest.mark.parametrize("mask", MASKS, ids=["1d", "2d", "3d", "none",
                                             "all"])
def test_where_condition_is_nonzero(mask):
    got = run("where", mask)
    assert len(got) == mask.ndim
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got], -1),
                                  np.argwhere(mask))
    run("nonzero", mask.astype(np.float32))


@pytest.mark.parametrize("kw", [dict(), dict(return_index=True,
                                             return_inverse=True,
                                             return_counts=True),
                                dict(return_counts=True, axis=0)])
def test_unique(kw):
    x = np.random.RandomState(2).randint(0, 4, (6, 3)).astype(np.float32)
    run("unique", x, **kw)


@pytest.mark.parametrize("kw", [dict(), dict(return_inverse=True,
                                             return_counts=True)])
def test_unique_consecutive(kw):
    x = np.array([1, 1, 2, 2, 2, 3, 1, 1], np.float32)
    run("unique_consecutive", x, **kw)


def _spd(n, seed):
    a = np.random.RandomState(seed).randn(n, n).astype(np.float32)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("name,args,kw", [
    ("inv", [_spd(4, 0)], {}),
    ("cholesky_inverse", [np.linalg.cholesky(_spd(4, 1)).astype(
        np.float32)], {}),
    ("matrix_exp", [np.random.RandomState(2).randn(4, 4).astype(
        np.float32) * 0.3], {}),
    ("vector_norm", [np.random.RandomState(3).randn(3, 5).astype(
        np.float32)], dict(p=3.0, axis=1)),
    ("vector_norm", [np.random.RandomState(3).randn(3, 5).astype(
        np.float32)], dict(p=0)),
    ("matrix_norm", [_spd(4, 4)], dict(p="nuc")),
    ("matrix_norm", [_spd(4, 4)], dict(p=1)),
    ("matrix_norm", [_spd(4, 4)], dict(p=-2)),
    ("cond", [_spd(4, 5)], {}),
    ("cond", [_spd(4, 5)], dict(p="fro")),
    ("cond", [_spd(4, 5)], dict(p=float("inf")))], ids=lambda v: str(v)[:20])
def test_linalg_tail(name, args, kw):
    run(name, *args, tol=1e-4, **kw)


def test_lu_and_lu_unpack():
    a = _spd(4, 6)
    lu, piv = run("lu", a, tol=1e-4)
    p_, l_, u_ = run("lu_unpack", lu.numpy(), piv.numpy(), tol=1e-4)
    np.testing.assert_allclose(p_.numpy() @ l_.numpy() @ u_.numpy(), a,
                               rtol=1e-4, atol=1e-4)


def _full_q(x, tau):
    """The m x m product of the Householder reflectors (numpy)."""
    m, n = x.shape
    q = np.eye(m)
    for i in range(n):
        v = np.concatenate([np.zeros(i), [1.0], x[i + 1:, i]])
        q = q @ (np.eye(m) - tau[i] * np.outer(v, v))
    return q


@pytest.mark.parametrize("left,transpose", [(True, False), (True, True),
                                            (False, False), (False, True)])
def test_ormqr(left, transpose):
    """Square x: against the JAX package. Tall x: the JAX package
    multiplies by Q's first n columns only (ROADMAP Queue 3), so the
    port is held to LAPACK's full Q, built here in numpy."""
    rng = np.random.RandomState(7)
    xs, taus = rng.randn(4, 4).astype(np.float32), rng.rand(4).astype(
        np.float32)
    ys = rng.randn(4, 4).astype(np.float32)
    run("ormqr", xs, taus, ys, tol=1e-4, left=left, transpose=transpose)
    x, tau = rng.randn(5, 3).astype(np.float32), rng.rand(3).astype(
        np.float32)
    y = rng.randn(5, 2).astype(np.float32) if left else rng.randn(
        2, 5).astype(np.float32)
    q = _full_q(x.astype(np.float64), tau.astype(np.float64))
    q = q.T if transpose else q
    want = q @ y if left else y @ q
    got = POPS["ormqr"].lowering(tp.to_tensor(x), tp.to_tensor(tau),
                                 tp.to_tensor(y), left=left,
                                 transpose=transpose)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    run("householder_product", x, tau, tol=1e-4)


def test_pca_lowrank():
    a = np.random.RandomState(8).randn(8, 5).astype(np.float32)
    outs = []
    for pkg, ops in ((jp, JOPS), (tp, POPS)):
        outs.append([np.abs(np.asarray(o.numpy())) for o in
                     ops["pca_lowrank"].lowering(pkg.to_tensor(a), q=3)])
    for j, p in zip(*outs):         # vectors up to a sign each
        np.testing.assert_allclose(p, j, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kw", [dict(bins=4), dict(bins=[3, 5],
                                                    density=True)])
def test_histogramdd(kw):
    x = np.random.RandomState(9).rand(50, 2).astype(np.float32)
    hist, edges = POPS["histogramdd"].lowering(tp.to_tensor(x), **kw)
    jhist, jedges = JOPS["histogramdd"].lowering(jp.to_tensor(x), **kw)
    np.testing.assert_allclose(hist.numpy(), np.asarray(jhist.numpy()),
                               rtol=1e-5, atol=1e-6)
    for e, je in zip(edges, jedges):
        np.testing.assert_allclose(e.numpy(), np.asarray(je.numpy()),
                                   rtol=1e-6, atol=1e-6)


def test_as_strided_combinations_frexp():
    x = np.arange(12, dtype=np.float32)
    run("as_strided", x, [3, 3], [3, 1], 1)
    run("combinations", np.array([1., 2., 3., 4.], np.float32), r=3)
    run("combinations", np.array([1., 2., 3.], np.float32),
        with_replacement=True)
    run("frexp", np.array([0.5, 3.0, -10.0, 1e-3], np.float32))


@pytest.mark.parametrize("method", ["linear", "lower", "higher", "nearest",
                                    "midpoint"])
def test_quantile_methods(method):
    x = np.random.RandomState(10).randn(4, 7).astype(np.float32)
    run("quantile", x, q=[0.1, 0.5, 0.9], axis=1, interpolation=method)
    x[1, 2] = np.nan
    run("nanquantile", x, q=0.3, axis=1, keepdim=True)


def test_median_lower_mode_is_the_lower_middle():
    """mode="min" gives the lower of the two middle values; the JAX
    package ignores ``mode`` (ROADMAP Queue 3), so the port is held to
    numpy's lower median."""
    x = np.random.RandomState(11).randn(3, 6).astype(np.float32)
    got = POPS["median"].lowering(tp.to_tensor(x), axis=1, mode="min")
    np.testing.assert_allclose(got.numpy(), np.sort(x, 1)[:, 2])
    run("median", x, axis=1)


def test_quantization_ops_through_the_registry():
    rng = np.random.RandomState(12)
    w = rng.randn(8, 6).astype(np.float32)
    q, s = run("weight_quantize", w)
    run("weight_dequantize", q.numpy(), s.numpy())
    x = rng.randn(3, 8).astype(np.float32)
    run("weight_only_linear", x, q.numpy(), None, s.numpy(), tol=1e-4)
    run("llm_int8_linear", x, q.numpy(), None, s.numpy(), tol=1e-4)
    run("apply_per_channel_scale", x, np.abs(x[0]) + 1.0)
    run("fake_quant", w)


def test_rotary_embedding_entry():
    x = np.random.RandomState(13).randn(2, 5, 2, 8).astype(np.float32)
    run("rotary_embedding", x, theta=10000.0, pos_offset=3)


def test_top_level_names_of_this_slice():
    for name in ("fft", "signal", "geometric", "linalg", "where_", "abs_",
                 "add_n", "polar", "complex", "real", "imag", "conj",
                 "angle", "svd", "eig", "histogram", "unique", "nonzero",
                 "kthvalue", "quantile", "stanh", "diff", "is_complex",
                 "broadcast_shape", "tolist", "shape"):
        assert hasattr(jp, name), name
        assert hasattr(tp, name), name
    assert tp.linalg.svd is tp.ops.linalg.svd
    assert tp.broadcast_shape([2, 1], [1, 3]) == jp.broadcast_shape(
        [2, 1], [1, 3])


RANK_CASES = [
    (np.diag([3.0, 1.0, 0.2]).astype(np.float32), 0.5, 2),
    (np.stack([np.diag([3.0, 1.0, 0.2]),
               np.diag([0.4, 0.3, 0.2])]).astype(np.float32), 0.35, [2, 1]),
]


@pytest.mark.parametrize("x,tol,want", RANK_CASES, ids=["one", "batch"])
def test_matrix_rank_tol_is_absolute(x, tol, want):
    got = [pkg.linalg.matrix_rank(pkg.to_tensor(x), tol=tol).numpy()
           for pkg in (jp, tp)]
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[1], got[0])


STRIDED_EMPTY = [([0], [0], [3], [-1]), ([0, 1], [3, 5], [1, 0], [1, -2])]


@pytest.mark.parametrize("region", STRIDED_EMPTY, ids=["rows", "both"])
def test_negative_stride_empty_region(region):
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    outs = []
    for pkg in (jp, tp):
        t = pkg.to_tensor(x)
        got = pkg.strided_slice(t, *region)
        value = pkg.to_tensor(np.ones(got.shape, np.float32))
        outs.append((got.numpy(), pkg.slice_scatter(t, value,
                                                    *region).numpy()))
    assert outs[1][0].shape == outs[0][0].shape
    assert outs[0][0].shape[0] == 0
    np.testing.assert_array_equal(outs[1][1], outs[0][1])
    np.testing.assert_array_equal(outs[1][1], x)
