"""The port's vision ops on the card against the same calls on the CPU
(plain PyTorch on both: the JAX package has no kernel here either), at
small sizes: values within TOL (relative to the largest), the input
gradients norm-wise within TOL, NMS's kept indices equal; and the zoo's
MobileNetV2 and GoogLeNet eval forwards against their CPU twins.

This file imports torch and the port only (no JAX), so it also runs on
a machine that has a card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_vision_ops_cuda.py

Without a card every test skips: it compares the card with the CPU.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch.vision import models
from paddle_tpu_torch.vision import ops as V

TOL = 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: it compares the card with the CPU")


def _boxes(rng, n, image, lo, hi):
    h, w = image
    wh = lo + rng.rand(n, 2) * (hi - lo)
    xy = rng.rand(n, 2) * (np.array([w, h]) - wh)
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _both(fn, arrays, diff):
    """fn(*tensors) on the card and on the CPU: (outputs, gradients of
    sum(out * w) for the flagged inputs) of each."""
    res = []
    for dev in ("gpu:0", "cpu"):
        with paddle.device_guard(dev):
            ts = [paddle.to_tensor(a, stop_gradient=not d)
                  for a, d in zip(arrays, diff)]
            out = fn(*ts)
            outs = list(out) if isinstance(out, (list, tuple)) else [out]
            if any(diff):
                loss = sum((o * paddle.to_tensor(np.random.RandomState(k)
                                                 .randn(*o.shape).astype(
                                                     np.float32))).sum()
                           for k, o in enumerate(outs))
                loss.backward()
            res.append(([o.numpy() for o in outs],
                        [t.grad.numpy() for t, d in zip(ts, diff) if d]))
    return res


def _assert_close(res):
    (o_card, g_card), (o_cpu, g_cpu) = res
    for a, b in zip(o_card, o_cpu):
        assert a.shape == b.shape
        if np.issubdtype(b.dtype, np.integer):
            np.testing.assert_array_equal(a, b)
        else:
            scale = max(1.0, float(np.abs(b).max()))
            assert float(np.abs(a - b).max()) <= TOL * scale
    for a, b in zip(g_card, g_cpu):
        assert np.linalg.norm(a - b) <= TOL * max(np.linalg.norm(b), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["roi_align", "roi_align_adaptive",
                                "roi_pool", "psroi_pool"])
def test_roi_ops(op):
    _card()
    rng = np.random.RandomState(0)
    channels = 18 if op == "psroi_pool" else 16
    x = rng.randn(2, channels, 40, 56).astype(np.float32)
    rois = _boxes(rng, 64, (160, 224), 8, 96)
    num = np.array([30, 34])
    fn = {"roi_align": lambda a, b: V.roi_align(a, b, num, 7, 0.25,
                                                sampling_ratio=2),
          "roi_align_adaptive": lambda a, b: V.roi_align(a, b, num, 7, 0.25),
          "roi_pool": lambda a, b: V.roi_pool(a, b, num, 7, 0.25),
          "psroi_pool": lambda a, b: V.psroi_pool(a, b, num, 3, 0.25)}[op]
    _assert_close(_both(fn, [x, rois], [True, False]))


@pytest.mark.cuda
def test_nms_family():
    _card()
    rng = np.random.RandomState(1)
    boxes = _boxes(rng, 300, (400, 600), 10, 120)
    scores = (rng.permutation(300).astype(np.float32) + 1) / 300
    _assert_close(_both(lambda b, s: V.nms(b, 0.5, s), [boxes, scores],
                        [False, False]))
    many = np.stack([_boxes(rng, 100, (400, 600), 10, 120)
                     for _ in range(2)])
    cls = rng.rand(2, 5, 100).astype(np.float32)
    for fn in (lambda b, s: V.multiclass_nms(b, s, 0.3, nms_threshold=0.5,
                                             return_index=True),
               lambda b, s: V.matrix_nms(b, s, 0.3, return_index=True)):
        _assert_close(_both(fn, [many, cls], [False, False]))


@pytest.mark.cuda
def test_deform_conv2d():
    _card()
    rng = np.random.RandomState(2)
    arrays = [rng.randn(2, 16, 20, 20).astype(np.float32),
              (2.0 * rng.randn(2, 18, 20, 20)).astype(np.float32),
              (rng.randn(24, 16, 3, 3) / 12).astype(np.float32),
              rng.rand(2, 9, 20, 20).astype(np.float32),
              rng.randn(24).astype(np.float32)]
    _assert_close(_both(lambda x, o, w, m, b: V.deform_conv2d(
        x, o, w, bias=b, padding=1, mask=m), arrays, [True] * 5))


@pytest.mark.cuda
def test_yolo_box_and_loss():
    _card()
    rng = np.random.RandomState(3)
    head = (0.5 * rng.randn(2, 3 * 85, 10, 10)).astype(np.float32)
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
               156, 198, 373, 326]
    img = np.array([[320, 320], [320, 320]], np.int32)
    _assert_close(_both(lambda x: V.yolo_box(
        x, paddle.to_tensor(img), anchors[12:], 80, 0.01, 32), [head],
        [True]))
    gt = np.zeros((2, 10, 4), np.float32)
    gt[:, :6, :2] = rng.rand(2, 6, 2) * 0.8 + 0.1
    gt[:, :6, 2:] = rng.rand(2, 6, 2) * 0.5 + 0.05
    gl = rng.randint(0, 80, (2, 10))
    _assert_close(_both(lambda x: V.yolo_loss(
        x, paddle.to_tensor(gt), paddle.to_tensor(gl), anchors, [6, 7, 8],
        80, 0.7, 32), [head], [True]))


@pytest.mark.cuda
def test_proposals_and_boxes():
    _card()
    rng = np.random.RandomState(4)
    a, h, w = 3, 12, 16
    sc = rng.rand(1, a, h, w).astype(np.float32)
    deltas = (0.1 * rng.randn(1, 4 * a, h, w)).astype(np.float32)
    cy, cx = np.meshgrid(np.arange(h) * 16 + 8, np.arange(w) * 16 + 8,
                         indexing="ij")
    anchors = np.stack([np.stack([cx - s, cy - s, cx + s, cy + s], -1)
                        for s in (16, 32, 64)], 2).astype(np.float32)
    ims = np.array([[192, 256]], np.float32)
    _assert_close(_both(lambda s, d, an: V.generate_proposals(
        s, d, paddle.to_tensor(ims), an, paddle.to_tensor(
            np.ones_like(anchors)), pre_nms_top_n=300, post_nms_top_n=50,
        nms_thresh=0.7), [sc, deltas, anchors], [False] * 3))
    prior = _boxes(rng, 50, (200, 300), 10, 100)
    target = (0.2 * rng.randn(50, 6, 4)).astype(np.float32)
    _assert_close(_both(lambda p, t: V.box_coder(
        p, [0.1, 0.1, 0.2, 0.2], t, "decode_center_size"), [prior, target],
        [False, False]))
    _assert_close(_both(lambda x, im: V.prior_box(
        x, im, [30.0], [60.0], (2.0,), flip=True, clip=True),
        [np.zeros((1, 8, 10, 10), np.float32),
         np.zeros((1, 3, 300, 300), np.float32)], [False, False]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mobilenet_v2", "googlenet"])
def test_zoo_eval_forward(name):
    _card()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with paddle.device_guard("gpu:0"):
        paddle.seed(5)
        card = getattr(models, name)(num_classes=10)
        state = {k: v.numpy() for k, v in card.state_dict().items()}
    with paddle.device_guard("cpu"):
        twin = getattr(models, name)(num_classes=10)
        twin.set_state_dict(state)
    x = np.random.RandomState(6).randn(2, 3, 96, 96).astype(np.float32)
    res = []
    for model, dev in ((card, "gpu:0"), (twin, "cpu")):
        with paddle.device_guard(dev), paddle.no_grad():
            model.eval()
            out = model(paddle.to_tensor(x))
            outs = list(out) if isinstance(out, (list, tuple)) else [out]
            res.append(([o.numpy() for o in outs], []))
    _assert_close(res)
