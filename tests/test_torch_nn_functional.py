"""The port's activation and common functionals against the JAX
package's (``paddle_tpu/nn/functional/activation.py`` and ``common.py``;
``test_torch_nn_norm_vision.py`` holds the norm and vision ones).

One parametrised case a functional (and more for the modes of
``interpolate``, ``pad`` and ``grid_sample``): the same numpy-seeded
inputs through both packages' Paddle API, the outputs within RTOL/ATOL
and, where the functional is differentiable, the input gradients of
sum(out * w) (w numpy-seeded) norm-wise within GRAD_RTOL
(``torch_nn_parity.check``). The functionals
that draw random numbers (their generators differ) are held to their
deterministic modes against the JAX package and to their laws alone.
"""
import numpy as np
import pytest

import paddle_tpu_torch as tp
from torch_nn_parity import _ints, _x, check

@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


X = _x(0, 3, 4, 5)
ACT = {
    "mish": lambda p, x: p.nn.functional.mish(x),
    "softsign": lambda p, x: p.nn.functional.softsign(x),
    "tanhshrink": lambda p, x: p.nn.functional.tanhshrink(x),
    "log_sigmoid": lambda p, x: p.nn.functional.log_sigmoid(x),
    "leaky_relu": lambda p, x: p.nn.functional.leaky_relu(x, 0.2),
    "elu": lambda p, x: p.nn.functional.elu(x, 0.7),
    "celu": lambda p, x: p.nn.functional.celu(x, 1.3),
    "selu": lambda p, x: p.nn.functional.selu(x),
    "hardtanh": lambda p, x: p.nn.functional.hardtanh(x, -0.5, 0.8),
    "hardshrink": lambda p, x: p.nn.functional.hardshrink(x, 0.4),
    "softshrink": lambda p, x: p.nn.functional.softshrink(x, 0.4),
    "softplus": lambda p, x: p.nn.functional.softplus(x, 2.0, 1.5),
    "thresholded_relu": lambda p, x: p.nn.functional.thresholded_relu(
        x, 0.3, -0.1),
    "log_softmax": lambda p, x: p.nn.functional.log_softmax(x, axis=1),
    "maxout": lambda p, x: p.nn.functional.maxout(x, 2, axis=1),
    "glu": lambda p, x: p.nn.functional.glu(x, axis=1),
    "rrelu_eval": lambda p, x: p.nn.functional.rrelu(x, 0.1, 0.3,
                                                     training=False),
}


@pytest.mark.parametrize("name", sorted(ACT))
def test_activation(name):
    check(ACT[name], X)


@pytest.mark.parametrize("shape", [(3, 4, 5), (1,)])
def test_prelu(shape):
    check(lambda p, x, w: p.nn.functional.prelu(x, w), X,
          _x(1, *shape[:1]) if shape == (1,) else _x(1, 4))


def test_prelu_channel_last():
    check(lambda p, x, w: p.nn.functional.prelu(x, w, data_format="NHWC"),
          _x(2, 2, 3, 3, 4), _x(3, 4))


def test_rrelu_training_slopes_in_range():
    x = tp.to_tensor(-np.abs(_x(4, 1000)))
    y = tp.nn.functional.rrelu(x, 0.1, 0.3, training=True).numpy()
    slope = y / x.numpy()
    assert slope.min() >= 0.1 and slope.max() <= 0.3 and slope.std() > 0.03


def test_gumbel_softmax_laws():
    x = tp.to_tensor(_x(5, 64, 7), stop_gradient=False)
    soft = tp.nn.functional.gumbel_softmax(x, temperature=0.5)
    np.testing.assert_allclose(soft.numpy().sum(-1), 1.0, rtol=1e-5)
    hard = tp.nn.functional.gumbel_softmax(x, hard=True)
    h = hard.numpy()
    assert set(np.unique(h)) == {0.0, 1.0} and (h.sum(-1) == 1).all()
    hard.sum().backward()
    assert x.grad is not None
    tp.seed(3)
    a = tp.nn.functional.gumbel_softmax(x).numpy()
    tp.seed(3)
    np.testing.assert_array_equal(a, tp.nn.functional.gumbel_softmax(
        x).numpy())


COMMON = {
    "one_hot": (lambda p, i: p.nn.functional.one_hot(i, 6),
                [_ints(0, 6, 3, 4)]),
    "label_smooth": (lambda p, y: p.nn.functional.label_smooth(
        y, epsilon=0.2), [np.eye(5, dtype=np.float32)[[0, 3, 1]]]),
    "label_smooth_prior": (lambda p, y, pd: p.nn.functional.label_smooth(
        y, pd, epsilon=0.1), [np.eye(4, dtype=np.float32)[[2, 0]],
                              np.full((1, 4), 0.25, np.float32)]),
    "cosine_similarity": (lambda p, a, b: p.nn.functional.cosine_similarity(
        a, b, axis=1), [_x(1, 3, 6), _x(2, 3, 6)]),
    "bilinear": (lambda p, a, b, w, bb: p.nn.functional.bilinear(a, b, w, bb),
                 [_x(3, 4, 3), _x(4, 4, 5), _x(5, 2, 3, 5), _x(6, 2)]),
    "embedding_bag_sum": (lambda p, i, w: p.nn.functional.embedding_bag(
        i, w), [_ints(1, 7, 3, 4), _x(7, 7, 5)]),
    "embedding_bag_mean_pad": (lambda p, i, w: p.nn.functional.embedding_bag(
        i, w, mode="mean", padding_idx=2), [_ints(2, 7, 3, 4), _x(8, 7, 5)]),
    "sequence_mask": (lambda p, l: p.nn.functional.sequence_mask(l, 6),
                      [np.array([0, 3, 6], np.int64)]),
    "sequence_mask_nomax": (lambda p, l: p.nn.functional.sequence_mask(l),
                            [np.array([[1, 4], [2, 0]], np.int64)]),
    "pixel_shuffle": (lambda p, x: p.nn.functional.pixel_shuffle(x, 2),
                      [_x(9, 2, 8, 3, 3)]),
    "pixel_shuffle_nhwc": (lambda p, x: p.nn.functional.pixel_shuffle(
        x, 2, "NHWC"), [_x(10, 2, 3, 3, 8)]),
    "pixel_unshuffle": (lambda p, x: p.nn.functional.pixel_unshuffle(x, 2),
                        [_x(11, 2, 3, 4, 6)]),
    "unfold": (lambda p, x: p.nn.functional.unfold(x, [2, 3], 1, 1, 1),
               [_x(12, 2, 3, 6, 7)]),
    "unfold_stride_pad4": (lambda p, x: p.nn.functional.unfold(
        x, 3, 2, [1, 0, 2, 1], 2), [_x(13, 1, 2, 9, 8)]),
    "fold": (lambda p, x: p.nn.functional.fold(x, [5, 6], [2, 3], 1, 1),
             [_x(14, 2, 3 * 6, 6 * 6)]),
    "fold_stride": (lambda p, x: p.nn.functional.fold(
        x, [6, 6], 2, 2, 0, 1), [_x(15, 1, 2 * 4, 9)]),
    "zeropad2d": (lambda p, x: p.nn.functional.zeropad2d(x, [1, 2, 0, 3]),
                  [_x(16, 1, 2, 3, 4)]),
    "dropout2d_eval": (lambda p, x: p.nn.functional.dropout2d(
        x, 0.5, training=False), [_x(17, 2, 3, 4, 4)]),
    "dropout3d_eval": (lambda p, x: p.nn.functional.dropout3d(
        x, 0.5, training=False), [_x(18, 2, 3, 2, 2, 2)]),
    "alpha_dropout_eval": (lambda p, x: p.nn.functional.alpha_dropout(
        x, 0.5, training=False), [_x(19, 5, 4)]),
}


@pytest.mark.parametrize("name", sorted(COMMON))
def test_common(name):
    fn, arrays = COMMON[name]
    check(fn, *arrays, jit=name != "sequence_mask_nomax")  # width on host


@pytest.mark.parametrize("mode", ["constant", "reflect", "replicate",
                                  "circular"])
@pytest.mark.parametrize("pad", [[1, 2, 3, 0], [0, 0, 0, 0, 2, 1, 1, 2]])
def test_pad(mode, pad):
    check(lambda p, x: p.nn.functional.pad(x, pad, mode=mode, value=0.5),
          _x(20, 2, 3, 4, 5))


def test_pad_channel_last_1d():
    check(lambda p, x: p.nn.functional.pad(x, [2, 1], mode="reflect",
                                           data_format="NLC"),
          _x(21, 2, 5, 3))


INTERP = [
    ("nearest", dict(size=[7, 5])),
    ("nearest", dict(scale_factor=0.5)),
    ("bilinear", dict(size=[9, 11])),
    ("bilinear", dict(size=[3, 2])),
    ("bilinear", dict(scale_factor=[1.5, 2.0], align_corners=True)),
    ("bicubic", dict(size=[8, 10])),
    ("bicubic", dict(size=[3, 5])),
    ("bicubic", dict(size=[8, 4], align_corners=True)),
    ("area", dict(size=[2, 3])),
    ("linear", dict(size=[11], data_format="NCW")),
    ("linear", dict(size=[3], align_corners=True, data_format="NCW")),
    ("trilinear", dict(size=[3, 5, 4])),
    ("bilinear", dict(size=[7, 3], data_format="NHWC")),
]


@pytest.mark.parametrize("i,mode,kw", [(i, m, k) for i, (m, k)
                                       in enumerate(INTERP)],
                         ids=[f"{m}-{i}" for i, (m, _) in enumerate(INTERP)])
def test_interpolate(i, mode, kw):
    fmt = kw.get("data_format", "NCHW")
    shape = {"NCHW": (2, 3, 6, 5), "NHWC": (2, 6, 5, 3), "NCW": (2, 3, 6),
             "NCDHW": (1, 2, 4, 3, 5)}[
        "NCDHW" if mode == "trilinear" else fmt]
    check(lambda p, x: p.nn.functional.interpolate(x, mode=mode, **kw),
          _x(22, *shape))


def test_upsample():
    check(lambda p, x: p.nn.functional.upsample(x, scale_factor=2,
                                                mode="bilinear"),
          _x(23, 1, 2, 3, 4))
