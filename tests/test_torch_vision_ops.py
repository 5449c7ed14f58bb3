"""The port's ``vision.ops`` against the JAX package's, on numpy-seeded
inputs at small sizes: the NMS family, anchors and boxes, YOLOv3's
decode and loss (values and gradients), proposals and FPN levels, image
I/O and the module's public names (the RoI pools, deformable convolution
and the correlation are in ``test_torch_vision_ops_roi.py``). Boxes are
tie-free (distinct scores, no IoU at a threshold), so both packages keep
the same boxes in the same order; kept indices, counts and detections
must then be equal (floats within TOL,
``tests/torch_vision_ops_util.py``), and the box clip's and bipartite
match's gradients within TOL.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu.vision.ops as JO
import paddle_tpu_torch as tp
import paddle_tpu_torch.vision.ops as TO
from torch_vision_ops_util import (assert_outs, grad_check, np_, rand_boxes,
                                   rand_rois)


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


# ------------------------------------------------------------------ NMS
def _nms_inputs(seed=0, n=40):
    rng = np.random.RandomState(seed)
    return rand_boxes(rng, n), rng.permutation(n).astype(np.float32) / n


@pytest.mark.parametrize("variant", ["scores", "no_scores", "categories",
                                     "top_k"])
def test_nms(variant):
    boxes, scores = _nms_inputs()
    cats = np.random.RandomState(1).randint(0, 3, len(boxes))
    kw = {"scores": {"scores": scores}, "no_scores": {},
          "categories": {"scores": scores, "category_idxs": cats,
                         "categories": [0, 1, 2]},
          "top_k": {"scores": scores, "top_k": 5}}[variant]
    outs = []
    for O, pkg in ((JO, jp), (TO, tp)):
        args = {k: (pkg.to_tensor(v) if isinstance(v, np.ndarray) else v)
                for k, v in kw.items()}
        outs.append(np_(O.nms(pkg.to_tensor(boxes), 0.3, **args)))
    np.testing.assert_array_equal(outs[1].astype(np.int64),
                                  outs[0].astype(np.int64))
    assert 0 < len(outs[0]) < len(boxes)


def test_nms_long_suppression_chain():
    """Boxes sliding by small steps: each suppresses the next, so the
    greedy answer alternates and needs as many sweeps as the chain is
    long."""
    x = np.arange(30, dtype=np.float32)[:, None] * 2.0
    boxes = np.concatenate([x, np.zeros_like(x), x + 10, np.full_like(x, 10)],
                           1)
    scores = np.linspace(1, 0.1, 30).astype(np.float32)
    got = np_(TO.nms(tp.to_tensor(boxes), 0.5, tp.to_tensor(scores)))
    ref = np_(JO.nms(jp.to_tensor(boxes), 0.5, jp.to_tensor(scores)))
    np.testing.assert_array_equal(got.astype(np.int64), ref.astype(np.int64))


def _multi_inputs(seed=2, batch=2, n=30, classes=4):
    rng = np.random.RandomState(seed)
    boxes = np.stack([rand_boxes(rng, n) for _ in range(batch)])
    scores = rng.rand(batch, classes, n).astype(np.float32)
    return boxes, scores


@pytest.mark.parametrize("gaussian", [False, True])
def test_matrix_nms(gaussian):
    boxes, scores = _multi_inputs()
    kw = dict(score_threshold=0.3, post_threshold=0.2, nms_top_k=20,
              keep_top_k=25, use_gaussian=gaussian, background_label=0,
              return_index=True, return_rois_num=True)
    j = JO.matrix_nms(jp.to_tensor(boxes), jp.to_tensor(scores), **kw)
    t = TO.matrix_nms(tp.to_tensor(boxes), tp.to_tensor(scores), **kw)
    assert_outs(j, t)
    assert int(np_(t[2]).sum()) > 0


@pytest.mark.parametrize("background", [-1, 0])
def test_multiclass_nms(background):
    boxes, scores = _multi_inputs(3)
    kw = dict(score_threshold=0.25, nms_top_k=15, keep_top_k=20,
              nms_threshold=0.4, background_label=background,
              return_index=True, return_rois_num=True)
    j = JO.multiclass_nms(jp.to_tensor(boxes), jp.to_tensor(scores), **kw)
    t = TO.multiclass_nms(tp.to_tensor(boxes), tp.to_tensor(scores), **kw)
    assert_outs(j, t)


# ------------------------------------------------------ anchors and boxes
PRIOR = {
    "plain": dict(min_sizes=[8.0]),
    "flip_clip_max": dict(min_sizes=[8.0, 16.0], max_sizes=[16.0, 30.0],
                          aspect_ratios=(1.0, 2.0, 0.5), flip=True,
                          clip=True),
    "order_steps": dict(min_sizes=[10.0], max_sizes=[20.0],
                        aspect_ratios=(2.0,), flip=True, steps=(4.0, 5.0),
                        offset=0.3, min_max_aspect_ratios_order=True),
}


@pytest.mark.parametrize("case", sorted(PRIOR))
def test_prior_box(case):
    feat = np.zeros((1, 4, 5, 6), np.float32)
    img = np.zeros((1, 3, 40, 48), np.float32)
    outs = [O.prior_box(pkg.to_tensor(feat), pkg.to_tensor(img),
                        **PRIOR[case]) for O, pkg in ((JO, jp), (TO, tp))]
    assert_outs(*outs)


BOX_CODER = {
    "encode": dict(code_type="encode_center_size"),
    "encode_var_list": dict(code_type="encode_center_size",
                            var=[0.1, 0.1, 0.2, 0.2]),
    "encode_var_tensor_pixels": dict(code_type="encode_center_size",
                                     var="tensor", box_normalized=False),
    "decode_axis0": dict(code_type="decode_center_size", var="tensor"),
    "decode_axis1": dict(code_type="decode_center_size", axis=1,
                         var=[0.1, 0.1, 0.2, 0.2]),
    "decode_2d": dict(code_type="decode_center_size", two_d=True),
}


@pytest.mark.parametrize("case", sorted(BOX_CODER))
def test_box_coder(case):
    kw = dict(BOX_CODER[case])
    rng = np.random.RandomState(8)
    prior = rand_boxes(rng, 5, 50, (5, 20))
    var = kw.pop("var", None)
    two_d = kw.pop("two_d", False)
    if kw["code_type"] == "encode_center_size":
        target = rand_boxes(rng, 3, 50, (5, 20))
    else:
        shape = (5, 4) if two_d else ((5, 3, 4) if kw.get("axis", 0) == 0
                                      else (3, 5, 4))
        target = (0.3 * rng.randn(*shape)).astype(np.float32)
    pvar = (rng.rand(5, 4).astype(np.float32) * 0.2 + 0.1) \
        if var == "tensor" else var
    outs = []
    for O, pkg in ((JO, jp), (TO, tp)):
        v = pkg.to_tensor(pvar) if isinstance(pvar, np.ndarray) else pvar
        outs.append(O.box_coder(pkg.to_tensor(prior), v,
                                pkg.to_tensor(target), **kw))
    assert_outs(*outs)


def test_box_clip():
    rng = np.random.RandomState(9)
    boxes = (rng.rand(1, 6, 4) * 80 - 10).astype(np.float32)
    info = np.array([[40.0, 50.0, 0.8]], np.float32)
    grad_check(lambda O, pkg, b, i: O.box_clip(b, i), [boxes, info],
                [True, False])


@pytest.mark.parametrize("match_type", ["bipartite", "per_prediction"])
def test_bipartite_match(match_type):
    rng = np.random.RandomState(10)
    d = rng.rand(4, 7).astype(np.float32)
    d[1] = 0.0                            # a row that never matches
    outs = []
    for O, pkg in ((JO, jp), (TO, tp)):
        t = pkg.to_tensor(d, stop_gradient=False)
        idx, dist = O.bipartite_match(t, match_type, dist_threshold=0.3)
        (dist * pkg.to_tensor(np.arange(7, dtype=np.float32)[None])
         ).sum().backward()
        outs.append((idx, dist, t.grad))
    assert_outs(outs[0], outs[1])


# ------------------------------------------------------------------ YOLO
YOLO_BOX = {
    "plain": dict(),
    "iou_aware_no_clip_scaled": dict(iou_aware=True, iou_aware_factor=0.4,
                                     clip_bbox=False, scale_x_y=1.05),
}


@pytest.mark.parametrize("case", sorted(YOLO_BOX))
def test_yolo_box(case):
    kw = YOLO_BOX[case]
    na, classes = 3, 4
    rng = np.random.RandomState(11)
    ch = na * (5 + classes) + (na if kw.get("iou_aware") else 0)
    x = rng.randn(2, ch, 5, 6).astype(np.float32)
    img = np.array([[160, 190], [150, 170]], np.int32)
    grad_check(lambda O, pkg, a: O.yolo_box(
        a, pkg.to_tensor(img), [10, 13, 16, 30, 33, 23], classes, 0.4, 32,
        **kw), [x], [True])


def _yolo_gt(rng, n=2, g=4, classes=4):
    cxy = rng.rand(n, g, 2) * 0.8 + 0.1
    wh = rng.rand(n, g, 2) * 0.4 + 0.05
    gt = np.concatenate([cxy, wh], 2).astype(np.float32)
    gt[1, 3] = 0.0                        # padding row: skipped
    return gt, rng.randint(0, classes, (n, g)), \
        rng.rand(n, g).astype(np.float32)


@pytest.mark.parametrize("case", ["smooth", "no_smooth_scored"])
def test_yolo_loss(case):
    rng = np.random.RandomState(12)
    na, classes = 3, 4
    x = (0.5 * rng.randn(2, na * (5 + classes), 6, 6)).astype(np.float32)
    gt, label, score = _yolo_gt(rng)
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]

    def fn(O, pkg, a):
        kw = dict(use_label_smooth=case == "smooth")
        if case != "smooth":
            kw["gt_score"] = pkg.to_tensor(score)
        return O.yolo_loss(a, pkg.to_tensor(gt), pkg.to_tensor(label),
                           anchors, [0, 1, 2], classes, 0.5, 32, **kw)
    grad_check(fn, [x], [True])


# --------------------------------------------------- proposals and levels
def test_generate_proposals():
    rng = np.random.RandomState(13)
    n, a, h, w = 2, 3, 6, 7
    scores = rng.permutation(n * a * h * w).astype(np.float32).reshape(
        n, a, h, w) / (n * a * h * w)
    deltas = (0.2 * rng.randn(n, 4 * a, h, w)).astype(np.float32)
    cy, cx = np.meshgrid(np.arange(h) * 16 + 8, np.arange(w) * 16 + 8,
                         indexing="ij")
    anchors = []
    for s in (16, 32, 48):
        anchors.append(np.stack([cx - s / 2, cy - s / 2, cx + s / 2,
                                 cy + s / 2], -1))
    anchors = np.stack(anchors, 2).reshape(h, w, a, 4).astype(np.float32)
    var = np.full_like(anchors, 1.0)
    img = np.array([[96, 112], [90, 100]], np.float32)
    kw = dict(pre_nms_top_n=60, post_nms_top_n=20, nms_thresh=0.6,
              min_size=4.0)
    outs = [O.generate_proposals(pkg.to_tensor(scores),
                                 pkg.to_tensor(deltas), pkg.to_tensor(img),
                                 pkg.to_tensor(anchors), pkg.to_tensor(var),
                                 **kw) for O, pkg in ((JO, jp), (TO, tp))]
    assert_outs(*outs)


def test_distribute_fpn_proposals():
    rois = rand_rois(14, 25, 200, (4, 180))
    outs = []
    for O, pkg in ((JO, jp), (TO, tp)):
        multi, restore, nums = O.distribute_fpn_proposals(
            pkg.to_tensor(rois), 2, 5, 4, 224, rois_num=np.array([25]))
        outs.append(multi + [restore] + nums)
    assert_outs(*outs)


# ------------------------------------------------------------- image I/O
@pytest.mark.parametrize("mode", ["unchanged", "gray", "rgb"])
def test_read_file_and_decode_jpeg(tmp_path, mode):
    from PIL import Image
    path = str(tmp_path / "x.jpg")
    rng = np.random.RandomState(18)
    Image.fromarray(rng.randint(0, 256, (9, 11, 3), dtype=np.uint8)).save(
        path, quality=90)
    outs = []
    for O in (JO, TO):
        raw = O.read_file(path)
        outs.append((raw, O.decode_jpeg(raw, mode=mode)))
    assert_outs(outs[0], outs[1])
    assert np_(outs[1][0]).dtype == np.uint8


def test_every_public_name_is_ported():
    assert sorted(TO.__all__) == sorted(JO.__all__)
    for name in TO.__all__:
        assert callable(getattr(TO, name)), name
    from paddle_tpu_torch.ops.registry import OPS
    for name in ("nms", "roi_align", "deform_conv2d", "yolo_loss"):
        assert OPS[name].category == "vision"
