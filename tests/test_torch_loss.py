"""The port's cross entropy and fused chunked LM-head loss against the
JAX package's.

Hard labels with softmax: the loss value and its gradient with respect
to the logits, for each reduction, with ``ignore_index`` and label
smoothing, on numpy-seeded logits shared by both sides.
``fused_linear_cross_entropy``: the loss and its gradients with respect
to x, the weight and the bias, fp32, within 1e-5 of the JAX package's and
of the port's own ``cross_entropy`` on the full logits.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch.nn.functional import (cross_entropy,
                                            fused_linear_cross_entropy)

TOL = 1e-5


def _inputs(n=12, c=37, seed=0, ignore=True):
    rng = np.random.RandomState(seed)
    logits = (3.0 * rng.randn(n, c)).astype(np.float32)
    labels = rng.randint(0, c, n).astype(np.int64)
    if ignore:
        labels[[2, 7]] = -100
    return logits, labels


def _jax(logits, labels, **kw):
    x = paddle.to_tensor(logits, stop_gradient=False)
    loss = JF.cross_entropy(x, paddle.to_tensor(labels), **kw)
    paddle.sum(loss).backward()
    return np.asarray(loss.numpy()), np.asarray(x.grad.numpy())


def _port(logits, labels, **kw):
    x = torch.from_numpy(logits).requires_grad_()
    loss = cross_entropy(x, torch.from_numpy(labels), **kw)
    loss.sum().backward()
    return loss.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("ignore", [False, True])
def test_matches_jax(reduction, label_smoothing, ignore):
    logits, labels = _inputs(ignore=ignore)
    kw = dict(reduction=reduction, label_smoothing=label_smoothing)
    j_loss, j_grad = _jax(logits, labels, **kw)
    loss, grad = _port(logits, labels, **kw)
    np.testing.assert_allclose(loss, j_loss, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(grad, j_grad, atol=TOL, rtol=TOL)
    if ignore:
        assert np.all(grad[[2, 7]] == 0.0)


def test_other_ignore_index_axis_and_label_shape():
    """A custom ignore_index, classes on axis 1 of a 3-d input, and
    labels with a trailing size-1 class dim."""
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 11, 5).astype(np.float32)
    labels = rng.randint(0, 11, (2, 1, 5)).astype(np.int64)
    labels[0, 0, 1] = 4
    kw = dict(axis=1, ignore_index=4)
    j_loss, j_grad = _jax(logits, labels, **kw)
    loss, grad = _port(logits, labels, **kw)
    np.testing.assert_allclose(loss, j_loss, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(grad, j_grad, atol=TOL, rtol=TOL)


def test_all_ignored_mean_is_zero():
    logits, labels = _inputs(n=4, ignore=False)
    labels[:] = -100
    loss, grad = _port(logits, labels)
    j_loss, _ = _jax(logits, labels)
    assert float(loss) == float(j_loss) == 0.0
    assert np.all(grad == 0.0)


def test_bf16_logits_reduce_in_fp32():
    logits, labels = _inputs(seed=5)
    x = torch.from_numpy(logits).to(torch.bfloat16)
    loss = cross_entropy(x, torch.from_numpy(labels))
    assert loss.dtype == torch.float32
    ref = cross_entropy(x.float(), torch.from_numpy(labels))
    assert abs(float(loss) - float(ref)) < 0.05


@pytest.mark.parametrize("kw", [dict(soft_label=True), dict(use_softmax=False),
                                dict(weight=torch.ones(37))])
def test_later_slice_options_raise(kw):
    logits, labels = _inputs()
    with pytest.raises(NotImplementedError, match="later slice"):
        cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                      **kw)


def _head_inputs(n, h=16, v=37, transpose_y=False, bias=False, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h).astype(np.float32)
    w = (rng.randn(*((v, h) if transpose_y else (h, v)))
         / np.sqrt(h)).astype(np.float32)
    b = rng.randn(v).astype(np.float32) if bias else None
    labels = rng.randint(0, v, n).astype(np.int64)
    labels[::5] = -100
    return x, w, b, labels


def _fused_jax(x, w, b, labels, **kw):
    ts = [paddle.to_tensor(a, stop_gradient=False)
          for a in (x, w) + ((b,) if b is not None else ())]
    loss = JF.fused_linear_cross_entropy(
        ts[0], ts[1], paddle.to_tensor(labels),
        bias=ts[2] if b is not None else None, **kw)
    paddle.sum(loss).backward()
    return [np.asarray(loss.numpy())] + [np.asarray(t.grad.numpy())
                                         for t in ts]


def _fused_port(x, w, b, labels, **kw):
    ts = [torch.from_numpy(a).requires_grad_()
          for a in (x, w) + ((b,) if b is not None else ())]
    loss = fused_linear_cross_entropy(
        ts[0], ts[1], torch.from_numpy(labels),
        bias=ts[2] if b is not None else None, **kw)
    loss.sum().backward()
    return [loss.detach().numpy()] + [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("n,chunk_rows", [(12, 4096), (23, 8), (16, 8)])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("transpose_y,bias", [(False, False), (True, False),
                                              (False, True)])
def test_fused_linear_cross_entropy_matches_jax(n, chunk_rows, reduction,
                                                transpose_y, bias):
    """Both weight layouts, a bias, ignored rows, each reduction, and N a
    multiple of chunk_rows, not one, and below it."""
    x, w, b, labels = _head_inputs(n, transpose_y=transpose_y, bias=bias,
                                   seed=n)
    kw = dict(transpose_y=transpose_y, reduction=reduction,
              chunk_rows=chunk_rows)
    want = _fused_jax(x, w, b, labels, **kw)
    got = _fused_port(x, w, b, labels, **kw)
    for name, g, j in zip(("loss", "dx", "dw", "db"), got, want):
        np.testing.assert_allclose(g, j, atol=TOL, rtol=TOL, err_msg=name)
    # and the port's own cross entropy on the full logits
    logits = x @ (w.T if transpose_y else w) + (b if bias else 0)
    plain, plain_dlogits = _port(logits.astype(np.float32), labels,
                                 reduction=reduction)
    np.testing.assert_allclose(got[0], plain, atol=TOL, rtol=TOL)
    dx = plain_dlogits @ (w if transpose_y else w.T)
    np.testing.assert_allclose(got[1], dx, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_fused_linear_cross_entropy_empty_and_custom_ignore(reduction):
    """N == 0 gives 0 (an empty vector for "none") with zero gradients, as
    the JAX package's; a custom ignore_index zeroes its rows."""
    x, w, _, labels = _head_inputs(0)
    got = _fused_port(x, w, None, labels, reduction=reduction)
    want = _fused_jax(x, w, None, labels, reduction=reduction)
    assert got[0].shape == np.asarray(want[0]).shape
    assert np.all(got[0] == 0) and np.all(got[2] == 0)
    x, w, _, labels = _head_inputs(9, seed=4)
    labels[:] = np.where(labels == -100, 3, labels)
    kw = dict(ignore_index=3, reduction=reduction, chunk_rows=4)
    for g, j in zip(_fused_port(x, w, None, labels, **kw),
                    _fused_jax(x, w, None, labels, **kw)):
        np.testing.assert_allclose(g, j, atol=TOL, rtol=TOL)


def test_fused_linear_cross_entropy_bf16_keeps_fp32_lse():
    """bf16 x and weight: the product in bf16, the loss fp32 and near the
    fp32 loss; the gradients come back in the inputs' dtype."""
    x, w, _, labels = _head_inputs(24, seed=9)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    tw = torch.from_numpy(w).to(torch.bfloat16).requires_grad_()
    loss = fused_linear_cross_entropy(tx, tw, torch.from_numpy(labels),
                                      chunk_rows=8)
    loss.backward()
    assert loss.dtype == torch.float32
    assert tx.grad.dtype == tw.grad.dtype == torch.bfloat16
    ref = _fused_port(x, w, None, labels)[0]
    assert abs(float(loss.detach()) - float(ref)) < 2e-2
