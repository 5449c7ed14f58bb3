"""The port's RoI pools, deformable convolution and FlowNet correlation
against the JAX package's, on numpy-seeded inputs at small sizes:
values, and the gradients of every differentiable input through
``sum(out * w)`` with a seeded w, within TOL
(``tests/torch_vision_ops_util.py``). The RoI pools use tie-free feature
maps, so each max has one arg.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu.vision.ops as JO
import paddle_tpu_torch as tp
import paddle_tpu_torch.vision.ops as TO
from torch_vision_ops_util import assert_outs, grad_check, rand_rois


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


# ------------------------------------------------------------ RoI pools
def _feature(seed, shape):
    # a permutation: every value distinct (tie-free maxima)
    rng = np.random.RandomState(seed)
    n = int(np.prod(shape))
    return (rng.permutation(n).astype(np.float32) / n).reshape(shape)


ROI_ALIGN = {
    "aligned_sr2": dict(sampling_ratio=2, aligned=True),
    "legacy_adaptive": dict(sampling_ratio=-1, aligned=False),
}


@pytest.mark.parametrize("case", sorted(ROI_ALIGN))
def test_roi_align(case):
    x = _feature(0, (2, 3, 12, 14))
    rois = rand_rois(1, 5, 40, (2, 24))
    grad_check(lambda O, pkg, a, b: O.roi_align(
        a, b, np.array([2, 3]), (3, 4), spatial_scale=0.25,
        **ROI_ALIGN[case]), [x, rois], [True, True])


def test_roi_pool():
    x = _feature(2, (2, 3, 12, 14))
    rois = rand_rois(3, 6, 40, (2, 30))
    grad_check(lambda O, pkg, a, b: O.roi_pool(
        a, b, np.array([4, 2]), 3, spatial_scale=0.25), [x, rois],
        [True, False])


def test_psroi_pool():
    x = _feature(4, (2, 2 * 3 * 3, 10, 12))
    rois = rand_rois(5, 5, 36, (3, 30))
    grad_check(lambda O, pkg, a, b: O.psroi_pool(
        a, b, np.array([3, 2]), 3, spatial_scale=0.25), [x, rois],
        [True, False])


@pytest.mark.parametrize("layer", ["RoIAlign", "RoIPool", "PSRoIPool"])
def test_roi_layers(layer):
    channels = 8 if layer == "PSRoIPool" else 3
    x = _feature(6, (1, channels, 10, 10))
    rois = rand_rois(7, 3, 30, (4, 20))
    outs = [getattr(O, layer)(2, spatial_scale=0.3)(
        pkg.to_tensor(x), pkg.to_tensor(rois), np.array([3]))
        for O, pkg in ((JO, jp), (TO, tp))]
    assert_outs(*outs)


# ----------------------------------------------------- deformable conv
DEFORM = {
    "v2_mask_bias": dict(mask=True, bias=True),
    "v1_groups_strided_dilated": dict(groups=2, deformable_groups=2,
                                      stride=2, padding=2, dilation=2),
}


@pytest.mark.parametrize("case", sorted(DEFORM))
def test_deform_conv2d(case):
    kw = dict(DEFORM[case])
    mask, bias = kw.pop("mask", False), kw.pop("bias", False)
    rng = np.random.RandomState(15)
    n, cin, cout, h, w, k = 2, 4, 6, 7, 8, 3
    groups, dg = kw.get("groups", 1), kw.get("deformable_groups", 1)
    s, p, d = kw.get("stride", 1), kw.get("padding", 0), kw.get("dilation", 1)
    ho = (h + 2 * p - (d * (k - 1) + 1)) // s + 1
    wo = (w + 2 * p - (d * (k - 1) + 1)) // s + 1
    arrays = [rng.randn(n, cin, h, w).astype(np.float32),
              (1.3 * rng.randn(n, 2 * dg * k * k, ho, wo)).astype(np.float32),
              rng.randn(cout, cin // groups, k, k).astype(np.float32)]
    names = ["x", "offset", "weight"]
    if mask:
        arrays.append(rng.rand(n, dg * k * k, ho, wo).astype(np.float32))
        names.append("mask")
    if bias:
        arrays.append(rng.randn(cout).astype(np.float32))
        names.append("bias")

    def fn(O, pkg, *ts):
        named = dict(zip(names, ts))
        return O.deform_conv2d(named["x"], named["offset"], named["weight"],
                               bias=named.get("bias"), mask=named.get("mask"),
                               **kw)
    grad_check(fn, arrays, [True] * len(arrays))


def test_deform_conv_layer():
    rng = np.random.RandomState(16)
    jp.seed(0)
    j = JO.DeformConv2D(4, 5, 3, padding=1)
    t = TO.DeformConv2D(4, 5, 3, padding=1)
    from paddle_tpu_torch.models import load_jax_layer_state
    load_jax_layer_state(t, {k: np.asarray(v.numpy())
                             for k, v in j.state_dict().items()})
    x = rng.randn(1, 4, 6, 6).astype(np.float32)
    off = rng.randn(1, 18, 6, 6).astype(np.float32)
    assert_outs(j(jp.to_tensor(x), jp.to_tensor(off)),
                 t(tp.to_tensor(x), tp.to_tensor(off)))


# --------------------------------------------------------- correlation
@pytest.mark.parametrize("kernel,disp,s1,s2", [(1, 2, 1, 1), (3, 4, 2, 2)])
def test_correlation(kernel, disp, s1, s2):
    rng = np.random.RandomState(17)
    a = rng.randn(1, 3, 9, 10).astype(np.float32)
    b = rng.randn(1, 3, 9, 10).astype(np.float32)
    pad = disp + (kernel - 1) // 2
    grad_check(lambda O, pkg, x1, x2: O.correlation(
        x1, x2, pad, kernel, disp, s1, s2), [a, b], [True, True])
