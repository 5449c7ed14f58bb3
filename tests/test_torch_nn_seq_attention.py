"""The port's sequence losses (CTC, RNN-T, hierarchical and adaptive
softmax), ``edit_distance``, ``ctc_align``, ``gather_tree`` and the
attention variants (``sparse_attention``, ``flash_attn_unpadded`` and
the packed and sparse-mask forms) against the JAX package's
(``paddle_tpu/nn/functional/loss.py``, ``tail.py``,
``flash_attention.py`` and ``ops/search.py``), through
``torch_nn_parity.check``: the same numpy-seeded inputs in both
packages, the values within RTOL/ATOL and the gradients of the float
inputs norm-wise within GRAD_RTOL.
"""
import numpy as np
import pytest

import paddle_tpu_torch as tp
from torch_nn_parity import _ints, _x, check


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


SEQ = {
    "hsigmoid_loss": (lambda p, x, y, w, b: p.nn.functional.hsigmoid_loss(
        x, y, 6, w, b), [_x(70, 4, 3), _ints(71, 6, 4), _x(72, 5, 3),
                         _x(73, 5)]),
    "hsigmoid_loss_custom_tree": (
        lambda p, x, y, w, t, c: p.nn.functional.hsigmoid_loss(
            x, y, 6, w, path_table=t, path_code=c),
        [_x(74, 3, 4), _ints(75, 6, 3), _x(76, 5, 4),
         np.array([[0, 1, -1], [0, 2, 4], [3, -1, -1]], np.int64),
         np.array([[1, 0, 0], [0, 1, 1], [1, 0, 0]], np.int64)]),
    "ctc_loss": (lambda p, lp, lab, il, ll: p.nn.functional.ctc_loss(
        lp, lab, il, ll, blank=0), [_x(77, 9, 3, 5), _ints(78, 4, 3, 3) + 1,
                                    np.array([9, 7, 5], np.int64),
                                    np.array([3, 2, 1], np.int64)]),
    "ctc_loss_sum_norm_by_times": (
        lambda p, lp, lab, il, ll: p.nn.functional.ctc_loss(
            lp, lab, il, ll, blank=4, reduction="sum", norm_by_times=True),
        [_x(79, 8, 2, 5), _ints(80, 4, 2, 3),
         np.array([8, 6], np.int64), np.array([3, 2], np.int64)]),
    "rnnt_loss": (lambda p, lg, lab, tl, ul: p.nn.functional.rnnt_loss(
        lg, lab, tl, ul, blank=0), [_x(81, 2, 4, 3, 5), _ints(82, 4, 2, 2) + 1,
                                    np.array([4, 3], np.int64),
                                    np.array([2, 1], np.int64)]),
    "rnnt_loss_sum": (lambda p, lg, lab, tl, ul: p.nn.functional.rnnt_loss(
        lg, lab, tl, ul, blank=2, fastemit_lambda=0.0, reduction="sum"),
        [_x(83, 2, 3, 3, 4), _ints(84, 2, 2, 2),
         np.array([3, 2], np.int64), np.array([2, 2], np.int64)]),
    "sparse_attention": (
        lambda p, q, k, v, off, col: p.nn.functional.sparse_attention(
            q, k, v, off, col),
        [_x(85, 1, 2, 4, 8), _x(86, 1, 2, 4, 8), _x(87, 1, 2, 4, 8),
         np.tile(np.arange(0, 9, 2, dtype=np.int32), (1, 2, 1)),
         np.tile(np.array([0, 1, 1, 2, 0, 2, 1, 3], np.int32), (1, 2, 1))]),
    "flash_attn_unpadded": (
        lambda p, q, k, v, cq, ck: p.nn.functional.flash_attn_unpadded(
            q, k, v, cq, ck, 4, 4, 0.3)[0],
        [_x(88, 7, 2, 8), _x(89, 7, 2, 8), _x(90, 7, 2, 8),
         np.array([0, 3, 7], np.int32), np.array([0, 3, 7], np.int32)]),
    "flash_attn_unpadded_causal": (
        lambda p, q, k, v, cq, ck: p.nn.functional.flash_attn_unpadded(
            q, k, v, cq, ck, 4, 4, 0.3, causal=True)[0],
        [_x(91, 7, 2, 8), _x(92, 7, 2, 8), _x(93, 7, 2, 8),
         np.array([0, 4, 7], np.int32), np.array([0, 4, 7], np.int32)]),
    "flash_attn_varlen_qkvpacked": (
        lambda p, qkv, cq, ck: p.nn.functional.flash_attn_varlen_qkvpacked(
            qkv, cq, ck, 4, 4, 0.3)[0],
        [_x(94, 6, 3, 2, 8), np.array([0, 2, 6], np.int32),
         np.array([0, 2, 6], np.int32)]),
    "flash_attn_qkvpacked": (
        lambda p, qkv: p.nn.functional.flash_attn_qkvpacked(
            qkv, causal=True)[0], [_x(95, 2, 5, 3, 2, 16)]),
    "flash_attention_with_sparse_mask": (
        lambda p, q, k, v, i: p.nn.functional.flash_attention_with_sparse_mask(
            q, k, v, i), [_x(96, 2, 5, 2, 8), _x(97, 2, 5, 2, 8),
                          _x(98, 2, 5, 2, 8), np.random.RandomState(99)
                          .randint(1, 6, (2, 2, 5)).astype(np.int32)]),
    "gather_tree": (lambda p, i, par: p.nn.functional.gather_tree(i, par),
                    [_ints(100, 9, 4, 2, 3), _ints(101, 3, 4, 2, 3)]),
    "edit_distance": (lambda p, a, b, la, lb: p.nn.functional.edit_distance(
        a, b, True, [0], la, lb), [_ints(102, 4, 3, 6), _ints(103, 4, 3, 5),
                                   np.array([6, 4, 0], np.int64),
                                   np.array([5, 2, 3], np.int64)]),
    "edit_distance_unnormalized": (
        lambda p, a, b: p.nn.functional.edit_distance(a, b, False),
        [_ints(104, 3, 4, 5), _ints(105, 3, 4, 4)]),
    "ctc_align": (lambda p, a, l: p.nn.functional.ctc_align(a, l, 0, -1),
                  [np.array([[0, 1, 1, 0, 2, 2], [3, 3, 0, 0, 1, 0]],
                            np.int64), np.array([6, 4], np.int64)]),
}


@pytest.mark.parametrize("name", sorted(SEQ))
def test_functional(name):
    fn, arrays = SEQ[name]
    check(fn, *arrays, jit=name != "ctc_align")     # a host decode
