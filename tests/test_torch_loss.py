"""The port's cross entropy against the JAX package's.

Hard labels with softmax: the loss value and its gradient with respect
to the logits, for each reduction, with ``ignore_index`` and label
smoothing, on numpy-seeded logits shared by both sides.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch.nn.functional import cross_entropy

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
