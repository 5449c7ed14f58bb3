"""The port's losses and distances, ``class_center_sample`` and the
in-place activations against the JAX package's
(``paddle_tpu/nn/functional/loss.py`` and ``tail.py``);
``test_torch_nn_seq_attention.py`` holds the sequence losses, the
attention variants and the search ops.

One parametrised case a functional, and one a reduction where it has
them, through ``torch_nn_parity.check``: the same numpy-seeded inputs in
both packages, the outputs within RTOL/ATOL and the gradients of the
float inputs norm-wise within GRAD_RTOL.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from torch_nn_parity import _ints, _x, check


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def _p(seed, *shape):
    return np.random.RandomState(seed).uniform(0.05, 0.95, shape).astype(
        np.float32)


def _pm1(seed, *shape):
    return np.where(np.random.RandomState(seed).rand(*shape) > 0.5, 1.0,
                    -1.0).astype(np.float32)


LOGITS, LABELS = _x(0, 6, 5), _ints(1, 5, 6)
LOSSES = {
    "mse_loss": (lambda p, a, b, r: p.nn.functional.mse_loss(a, b, r),
                 [_x(2, 4, 3), _x(3, 4, 3)]),
    "l1_loss": (lambda p, a, b, r: p.nn.functional.l1_loss(a, b, r),
                [_x(4, 4, 3), _x(5, 4, 3)]),
    "smooth_l1_loss": (lambda p, a, b, r: p.nn.functional.smooth_l1_loss(
        a, b, r, delta=0.7), [_x(6, 4, 3), _x(7, 4, 3)]),
    "huber_loss": (lambda p, a, b, r: p.nn.functional.huber_loss(
        a, b, 0.7, r), [_x(8, 4, 3), _x(9, 4, 3)]),
    "nll_loss": (lambda p, a, y, w, r: p.nn.functional.nll_loss(
        p.nn.functional.log_softmax(a), y, w, ignore_index=2, reduction=r),
        [LOGITS, LABELS, _p(10, 5)]),
    "binary_cross_entropy": (
        lambda p, a, y, w, r: p.nn.functional.binary_cross_entropy(
            a, y, w, r), [_p(11, 4, 3), _p(12, 4, 3), _p(13, 4, 3)]),
    "binary_cross_entropy_with_logits": (
        lambda p, a, y, w, pw, r:
        p.nn.functional.binary_cross_entropy_with_logits(a, y, w, r, pw),
        [_x(14, 4, 3), _p(15, 4, 3), _p(16, 4, 3), _p(17, 3)]),
    "kl_div": (lambda p, a, t, r: p.nn.functional.kl_div(
        p.nn.functional.log_softmax(a), t, r), [_x(18, 4, 5), _p(19, 4, 5)]),
    "margin_ranking_loss": (
        lambda p, a, b, y, r: p.nn.functional.margin_ranking_loss(
            a, b, y, 0.3, r), [_x(20, 7), _x(21, 7), _pm1(22, 7)]),
    "hinge_embedding_loss": (
        lambda p, a, y, r: p.nn.functional.hinge_embedding_loss(
            a, y, 0.8, r), [_x(23, 4, 3), _pm1(24, 4, 3)]),
    "cosine_embedding_loss": (
        lambda p, a, b, y, r: p.nn.functional.cosine_embedding_loss(
            a, b, y, 0.2, r), [_x(25, 5, 4), _x(26, 5, 4), _pm1(27, 5)]),
    "triplet_margin_loss": (
        lambda p, a, b, c, r: p.nn.functional.triplet_margin_loss(
            a, b, c, 0.5, 2.0, swap=True, reduction=r),
        [_x(28, 5, 4), _x(29, 5, 4), _x(30, 5, 4)]),
    "sigmoid_focal_loss": (
        lambda p, a, y, n, r: p.nn.functional.sigmoid_focal_loss(
            a, y, n, reduction=r),
        [_x(31, 4, 3), (_p(32, 4, 3) > 0.5).astype(np.float32),
         np.array([3.0], np.float32)]),
    "poisson_nll_loss": (
        lambda p, a, y, r: p.nn.functional.poisson_nll_loss(
            a, y, full=True, reduction=r), [_x(33, 4, 3), 3 * _p(34, 4, 3)]),
    "multi_label_soft_margin_loss": (
        lambda p, a, y, w, r: p.nn.functional.multi_label_soft_margin_loss(
            a, y, w, r), [_x(35, 4, 3), (_p(36, 4, 3) > .5).astype(
                np.float32), _p(37, 3)]),
    "soft_margin_loss": (lambda p, a, y, r: p.nn.functional.soft_margin_loss(
        a, y, r), [_x(38, 4, 3), _pm1(39, 4, 3)]),
    "multi_margin_loss": (
        lambda p, a, y, w, r: p.nn.functional.multi_margin_loss(
            a, y, 2, 0.9, w, r), [LOGITS, LABELS, _p(40, 5)]),
    "gaussian_nll_loss": (
        lambda p, a, y, v, r: p.nn.functional.gaussian_nll_loss(
            a, y, v, full=True, reduction=r),
        [_x(41, 4, 3), _x(42, 4, 3), _p(43, 4, 3)]),
    "triplet_margin_with_distance_loss": (
        lambda p, a, b, c, r:
        p.nn.functional.triplet_margin_with_distance_loss(
            a, b, c, margin=0.4, swap=True, reduction=r),
        [_x(44, 5, 4), _x(45, 5, 4), _x(46, 5, 4)]),
}


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss(name, reduction):
    fn, arrays = LOSSES[name]
    check(lambda p, *t: fn(p, *t, reduction), *arrays)


def test_kl_div_batchmean_log_target():
    check(lambda p, a, t: p.nn.functional.kl_div(
        a, t, "batchmean", log_target=True), _x(47, 4, 5), _x(48, 4, 5))


ONE = {
    "softmax_with_cross_entropy": (
        lambda p, a, y: p.nn.functional.softmax_with_cross_entropy(
            a, y, return_softmax=True), [LOGITS, LABELS[:, None]]),
    "cross_entropy_soft_label_smoothing": (
        lambda p, a, y: p.nn.functional.cross_entropy(
            a, p.nn.functional.label_smooth(p.nn.functional.one_hot(y, 5),
                                            epsilon=0.1), soft_label=True),
        [LOGITS, LABELS]),
    "square_error_cost": (lambda p, a, b: p.nn.functional.square_error_cost(
        a, b), [_x(50, 3, 4), _x(51, 3, 4)]),
    "log_loss": (lambda p, a, y: p.nn.functional.log_loss(a, y),
                 [_p(52, 5, 1), (_p(53, 5, 1) > .5).astype(np.float32)]),
    "pairwise_distance": (lambda p, a, b: p.nn.functional.pairwise_distance(
        a, b, 3.0, keepdim=True), [_x(54, 4, 6), _x(55, 4, 6)]),
    "dice_loss": (lambda p, a, y: p.nn.functional.dice_loss(
        p.nn.functional.softmax(a), y), [_x(56, 3, 4, 5), _ints(57, 5, 3, 4,
                                                                   1)]),
    "npair_loss": (lambda p, a, b, y: p.nn.functional.npair_loss(a, b, y),
                   [_x(58, 6, 4), _x(59, 6, 4), _ints(60, 3, 6)]),
    "margin_cross_entropy": (
        lambda p, a, y: p.nn.functional.margin_cross_entropy(
            a, y, 1.0, 0.3, 0.1, 8.0, return_softmax=True),
        [np.tanh(_x(61, 6, 5)), LABELS]),
    "adaptive_log_softmax_with_loss": (
        lambda p, x, y, hw, a1, a2, b1, b2, hb:
        p.nn.functional.adaptive_log_softmax_with_loss(
            x, y, hw, [(a1, a2), (b1, b2)], [3, 6, 9], hb),
        [_x(62, 7, 8), _ints(63, 9, 7), _x(64, 8, 5), _x(65, 8, 4),
         _x(66, 4, 3), _x(67, 8, 2), _x(68, 2, 3), _x(69, 5)]),
}


@pytest.mark.parametrize("name", sorted(ONE))
def test_functional(name):
    fn, arrays = ONE[name]
    check(fn, *arrays)


INPLACE = ["elu_", "hardtanh_", "leaky_relu_", "relu_", "softmax_",
           "tanh_", "thresholded_relu_"]


@pytest.mark.parametrize("name", INPLACE)
def test_inplace_activation(name):
    """The Tensor itself takes the result, equal to the JAX package's."""
    x = _x(110, 3, 4)
    outs = []
    for p in (jp, tp):
        t = p.to_tensor(x)
        r = getattr(p.nn.functional, name)(t)
        assert r is t
        outs.append(np.asarray(t.numpy()))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)


def test_inplace_activation_keeps_the_graph():
    x = tp.to_tensor(_x(111, 3, 4), stop_gradient=False)
    y = x * 2.0
    tp.nn.functional.relu_(y)
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), 2.0 * (_x(111, 3, 4) > 0))


def test_class_center_sample():
    lab = np.array([2, 7, 2, 9, 4], np.int64)
    tp.seed(5)
    remap, sampled = tp.nn.functional.class_center_sample(
        tp.to_tensor(lab), 20, 8)
    s = sampled.numpy()
    assert len(s) == 8 and set([2, 4, 7, 9]) <= set(s.tolist())
    assert (np.sort(s) == s).all()
    np.testing.assert_array_equal(s[remap.numpy()], lab)
    j_remap, j_sampled = jp.nn.functional.class_center_sample(
        jp.to_tensor(lab), 20, 3)
    remap, sampled = tp.nn.functional.class_center_sample(
        tp.to_tensor(lab), 20, 3)
    np.testing.assert_array_equal(sampled.numpy(), np.asarray(
        j_sampled.numpy()))
    np.testing.assert_array_equal(remap.numpy(), np.asarray(j_remap.numpy()))


def test_sdp_kernel_is_a_context():
    with tp.nn.functional.sdp_kernel(enable_math=True):
        pass
