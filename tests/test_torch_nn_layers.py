"""The port's layers of this slice (activations, common, losses, norms,
pools, the tail layers) against the JAX package's.

Each layer is built in both packages, the JAX layer's numpy state
carried into the port's (``load_jax_layer_state``), and called on the
same numpy-seeded inputs: the outputs within RTOL/ATOL. The gradients of
these layers' parameters are their functionals' weight gradients, held
in ``test_torch_nn_functional.py``, ``test_torch_nn_norm_vision.py``,
``test_torch_nn_losses.py`` and ``test_torch_nn_seq_attention.py``; the
layers whose forward holds more than one functional (``SpectralNorm``'s
power iteration, the RNNs, the transformer) have their parameter
gradients held here and in their own files, norm-wise within GRAD_RTOL.
``load_jax_layer_state`` raises on a missing and on an unexpected key.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.models import load_jax_layer_state
from torch_nn_parity import (_ints, _x, assert_layer_grads, check,
                             layer_grads, pair, port_layer_grads)
from torch_paddle_api import assert_same

RTOL, ATOL = 1e-5, 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def _p(seed, *shape):
    return np.random.RandomState(seed).uniform(0.05, 0.95, shape).astype(
        np.float32)


X4 = _x(0, 2, 4, 6, 6)
# name -> (ctor(package), inputs, call(layer, *tensors) or None)
LAYERS = {
    "CELU": (lambda p: p.nn.CELU(0.8), [X4], None),
    "ELU": (lambda p: p.nn.ELU(0.5), [X4], None),
    "SELU": (lambda p: p.nn.SELU(), [X4], None),
    "GLU": (lambda p: p.nn.GLU(axis=1), [X4], None),
    "Hardshrink": (lambda p: p.nn.Hardshrink(0.3), [X4], None),
    "Hardtanh": (lambda p: p.nn.Hardtanh(-0.4, 0.6), [X4], None),
    "LeakyReLU": (lambda p: p.nn.LeakyReLU(0.3), [X4], None),
    "LogSigmoid": (lambda p: p.nn.LogSigmoid(), [X4], None),
    "LogSoftmax": (lambda p: p.nn.LogSoftmax(1), [X4], None),
    "Maxout": (lambda p: p.nn.Maxout(2), [X4], None),
    "Mish": (lambda p: p.nn.Mish(), [X4], None),
    "PReLU": (lambda p: p.nn.PReLU(4, 0.1), [X4], None),
    "RReLU": (lambda p: p.nn.RReLU(0.1, 0.2), [X4], None),
    "Softplus": (lambda p: p.nn.Softplus(1.5, 10.0), [X4], None),
    "Softshrink": (lambda p: p.nn.Softshrink(0.2), [X4], None),
    "Softsign": (lambda p: p.nn.Softsign(), [X4], None),
    "Tanhshrink": (lambda p: p.nn.Tanhshrink(), [X4], None),
    "ThresholdedReLU": (lambda p: p.nn.ThresholdedReLU(0.5), [X4], None),
    "Softmax2D": (lambda p: p.nn.Softmax2D(), [X4], None),
    "Dropout2D": (lambda p: p.nn.Dropout2D(0.3), [X4], None),
    "Dropout3D": (lambda p: p.nn.Dropout3D(0.3), [_x(1, 2, 3, 2, 2, 2)],
                  None),
    "AlphaDropout": (lambda p: p.nn.AlphaDropout(0.3), [X4], None),
    "Upsample": (lambda p: p.nn.Upsample(size=[9, 7], mode="bicubic"), [X4],
                 None),
    "UpsamplingNearest2D": (lambda p: p.nn.UpsamplingNearest2D(
        scale_factor=2), [X4], None),
    "UpsamplingBilinear2D": (lambda p: p.nn.UpsamplingBilinear2D(
        size=[8, 5]), [X4], None),
    "Pad1D": (lambda p: p.nn.Pad1D([1, 2], mode="reflect"),
              [_x(2, 2, 3, 5)], None),
    "Pad2D": (lambda p: p.nn.Pad2D(1, mode="replicate"), [X4], None),
    "Pad3D": (lambda p: p.nn.Pad3D([1, 0, 0, 1, 2, 1], mode="circular"),
              [_x(3, 1, 2, 3, 3, 3)], None),
    "ZeroPad1D": (lambda p: p.nn.ZeroPad1D([2, 1]), [_x(4, 2, 3, 5)], None),
    "ZeroPad2D": (lambda p: p.nn.ZeroPad2D([1, 0, 2, 1]), [X4], None),
    "ZeroPad3D": (lambda p: p.nn.ZeroPad3D([1] * 6), [_x(5, 1, 2, 2, 2, 2)], None),
    "CosineSimilarity": (lambda p: p.nn.CosineSimilarity(axis=1),
                         [_x(6, 3, 5), _x(7, 3, 5)], None),
    "PairwiseDistance": (lambda p: p.nn.PairwiseDistance(1.5, keepdim=True),
                         [_x(8, 3, 5), _x(9, 3, 5)], None),
    "Bilinear": (lambda p: p.nn.Bilinear(3, 4, 2), [_x(10, 5, 3),
                                                    _x(11, 5, 4)], None),
    "PixelShuffle": (lambda p: p.nn.PixelShuffle(2), [X4], None),
    "PixelUnshuffle": (lambda p: p.nn.PixelUnshuffle(3), [X4], None),
    "ChannelShuffle": (lambda p: p.nn.ChannelShuffle(2), [X4], None),
    "Unfold": (lambda p: p.nn.Unfold([2, 3], 2, 1), [X4], None),
    "Fold": (lambda p: p.nn.Fold([4, 5], 2, 1, 0), [_x(12, 2, 8, 12)], None),
    "Unflatten": (lambda p: p.nn.Unflatten(1, [2, 2]), [X4], None),
    "GroupNorm": (lambda p: p.nn.GroupNorm(2, 4), [X4], None),
    "InstanceNorm1D": (lambda p: p.nn.InstanceNorm1D(3), [_x(13, 2, 3, 7)],
                       None),
    "InstanceNorm2D": (lambda p: p.nn.InstanceNorm2D(4), [X4], None),
    "InstanceNorm3D": (lambda p: p.nn.InstanceNorm3D(2),
                       [_x(14, 2, 2, 3, 2, 2)], None),
    "LocalResponseNorm": (lambda p: p.nn.LocalResponseNorm(3), [X4], None),
    "SyncBatchNorm": (lambda p: p.nn.SyncBatchNorm(4), [X4], None),
    "SpectralNorm": (lambda p: p.nn.SpectralNorm([4, 6], power_iters=3),
                     [_x(15, 4, 6)], None),
    "MaxUnPool1D": (lambda p: p.nn.MaxUnPool1D(2), [_x(16, 2, 3, 8)],
                    lambda p, l, x: l(*p.nn.functional.max_pool1d(
                        x, 2, return_mask=True))),
    "MaxUnPool2D": (lambda p: p.nn.MaxUnPool2D(2), [X4],
                    lambda p, l, x: l(*p.nn.functional.max_pool2d(
                        x, 2, return_mask=True))),
    "MaxUnPool3D": (lambda p: p.nn.MaxUnPool3D(2), [_x(17, 1, 2, 4, 4, 4)],
                    lambda p, l, x: l(*p.nn.functional.max_pool3d(
                        x, 2, return_mask=True))),
    "FractionalMaxPool2D": (lambda p: p.nn.FractionalMaxPool2D(
        3, random_u=0.3), [X4], None),
    "FractionalMaxPool3D": (lambda p: p.nn.FractionalMaxPool3D(
        2, random_u=0.6), [_x(18, 1, 2, 5, 5, 5)], None),
    "LPPool1D": (lambda p: p.nn.LPPool1D(2, 3, 2), [_x(19, 2, 3, 9)], None),
    "LPPool2D": (lambda p: p.nn.LPPool2D(3, 2), [np.abs(X4)], None),
    "MSELoss": (lambda p: p.nn.MSELoss("sum"), [_x(20, 4, 3), _x(21, 4, 3)],
                None),
    "L1Loss": (lambda p: p.nn.L1Loss(), [_x(22, 4, 3), _x(23, 4, 3)], None),
    "SmoothL1Loss": (lambda p: p.nn.SmoothL1Loss("none", 0.5),
                     [_x(24, 4, 3), _x(25, 4, 3)], None),
    "NLLLoss": (lambda p: p.nn.NLLLoss(), [_x(26, 5, 4), _ints(27, 4, 5)],
                None),
    "BCELoss": (lambda p: p.nn.BCELoss(), [_p(28, 4, 3), _p(29, 4, 3)], None),
    "BCEWithLogitsLoss": (lambda p: p.nn.BCEWithLogitsLoss(),
                          [_x(30, 4, 3), _p(31, 4, 3)], None),
    "KLDivLoss": (lambda p: p.nn.KLDivLoss("batchmean"),
                  [_x(32, 4, 3), _p(33, 4, 3)], None),
    "MarginRankingLoss": (lambda p: p.nn.MarginRankingLoss(0.2),
                          [_x(34, 6), _x(35, 6), np.sign(_x(36, 6))], None),
    "HingeEmbeddingLoss": (lambda p: p.nn.HingeEmbeddingLoss(),
                           [_x(37, 6), np.sign(_x(38, 6))], None),
    "CosineEmbeddingLoss": (lambda p: p.nn.CosineEmbeddingLoss(0.1),
                            [_x(39, 4, 3), _x(40, 4, 3), np.sign(_x(41, 4))],
                            None),
    "TripletMarginLoss": (lambda p: p.nn.TripletMarginLoss(),
                          [_x(42, 4, 3), _x(43, 4, 3), _x(44, 4, 3)], None),
    "TripletMarginWithDistanceLoss": (
        lambda p: p.nn.TripletMarginWithDistanceLoss(margin=0.3),
        [_x(45, 4, 3), _x(46, 4, 3), _x(47, 4, 3)], None),
    "PoissonNLLLoss": (lambda p: p.nn.PoissonNLLLoss(),
                       [_x(48, 4, 3), _p(49, 4, 3)], None),
    "MultiLabelSoftMarginLoss": (lambda p: p.nn.MultiLabelSoftMarginLoss(),
                                 [_x(50, 4, 3), (_p(51, 4, 3) > .5).astype(
                                     np.float32)], None),
    "MultiMarginLoss": (lambda p: p.nn.MultiMarginLoss(),
                        [_x(52, 5, 4), _ints(53, 4, 5)], None),
    "SoftMarginLoss": (lambda p: p.nn.SoftMarginLoss(),
                       [_x(54, 4, 3), np.sign(_x(55, 4, 3))], None),
    "GaussianNLLLoss": (lambda p: p.nn.GaussianNLLLoss(),
                        [_x(56, 4, 3), _x(57, 4, 3), _p(58, 4, 3)], None),
    "CTCLoss": (lambda p: p.nn.CTCLoss(), [_x(59, 6, 2, 4),
                                           _ints(60, 3, 2, 2) + 1,
                                           np.array([6, 5], np.int64),
                                           np.array([2, 1], np.int64)], None),
    "RNNTLoss": (lambda p: p.nn.RNNTLoss(), [_x(61, 2, 3, 3, 4),
                                             _ints(62, 3, 2, 2) + 1,
                                             np.array([3, 2], np.int64),
                                             np.array([2, 1], np.int64)],
                 None),
    "HSigmoidLoss": (lambda p: p.nn.HSigmoidLoss(3, 5),
                     [_x(63, 4, 3), _ints(64, 5, 4)], None),
    "AdaptiveLogSoftmaxWithLoss": (
        lambda p: p.nn.AdaptiveLogSoftmaxWithLoss(6, 10, [4, 7]),
        [_x(65, 5, 6), _ints(66, 10, 5)], None),
}
# eval-mode layers (their training draws differ between the packages)
EVAL = {"RReLU", "Dropout2D", "Dropout3D", "AlphaDropout"}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer(name):
    ctor, arrays, call = LAYERS[name]
    jl, tl = pair(ctor, seed=7)
    if name in EVAL:
        jl.eval()
        tl.eval()

    def run(package):
        return (lambda layer, *ts: call(package, layer, *ts)) if call \
            else (lambda layer, *ts: layer(*ts))
    j_out, j_grads = layer_grads(jl, run(jp), *arrays)
    t_out, t_grads = port_layer_grads(tl, run(tp), *arrays)
    assert_same(j_out, t_out, rtol=RTOL, atol=ATOL)
    assert_layer_grads(j_grads, t_grads,
                       [n for n, _ in tl.named_parameters()])


def test_spectral_norm_input_gradient():
    jl, tl = pair(LAYERS["SpectralNorm"][0], seed=7)
    check(lambda p, w: (jl if p is jp else tl)(w), _x(15, 4, 6))


def test_sync_batch_norm_is_batch_norm_on_one_process():
    x = tp.to_tensor(X4)
    sync, bn = tp.nn.SyncBatchNorm(4), tp.nn.BatchNorm2D(4)
    np.testing.assert_allclose(sync(x).numpy(), bn(x).numpy(), rtol=1e-6)
    np.testing.assert_allclose(sync._mean.numpy(), bn._mean.numpy())
    net = tp.nn.Sequential(tp.nn.Conv2D(4, 4, 1), tp.nn.BatchNorm2D(4))
    conv = tp.nn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert isinstance(conv[1], tp.nn.SyncBatchNorm)


def test_sync_batch_norm_all_reduces_over_the_group():
    """Two gloo processes, each with half of a batch: outputs, input
    gradients and running statistics those of one BatchNorm over the
    whole batch."""
    import socket
    import torch.multiprocessing as mp
    import torch_sync_bn_worker
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=torch_sync_bn_worker.run,
                         args=(rank, port, queue)) for rank in range(2)]
    for proc in procs:
        proc.start()
    results = dict((r[0], r[1:]) for r in (queue.get(timeout=120)
                                           for _ in procs))
    for proc in procs:
        proc.join(timeout=60)
        assert not proc.is_alive() and proc.exitcode == 0
    x = tp.to_tensor(np.random.RandomState(0).randn(4, 3, 5, 5).astype(
        np.float32), stop_gradient=False)
    bn = tp.nn.BatchNorm2D(3)
    out = bn(x)
    (out * out).sum().backward()
    for rank, (y, grad, mean, var) in results.items():
        rows = slice(2 * rank, 2 * rank + 2)
        np.testing.assert_allclose(y, out.numpy()[rows], atol=1e-5)
        np.testing.assert_allclose(grad, x.grad.numpy()[rows], atol=1e-4)
        np.testing.assert_allclose(mean, bn._mean.numpy(), atol=1e-6)
        np.testing.assert_allclose(var, bn._variance.numpy(), atol=1e-5)


def test_load_jax_layer_state_raises_on_missing_and_unexpected_keys():
    jl = jp.nn.GroupNorm(2, 4)
    tl = tp.nn.GroupNorm(2, 4)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    missing = dict(state)
    missing.pop("weight")
    with pytest.raises(KeyError, match="missing"):
        load_jax_layer_state(tl, missing)
    extra = dict(state, stray=np.zeros(2, np.float32))
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_layer_state(tl, extra)
