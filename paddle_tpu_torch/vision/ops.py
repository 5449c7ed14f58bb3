"""Detection and vision ops (counterpart of ``paddle_tpu/vision/ops.py``):
the NMS family, the RoI pools, anchors and box codecs, YOLOv3's decode
and loss, proposals, FPN level assignment, deformable convolution, the
FlowNet correlation and image I/O.

Plain PyTorch on the input's device, with the JAX module's math: the
JAX package has no Pallas kernel here either (its ops are jnp). What
differs is how the work is laid out for torch:

* Greedy NMS keeps box i when no kept box before it (in score order)
  overlaps it above the threshold. The JAX module runs that as a
  ``lax.scan`` of N steps; the port solves the same triangular system by
  sweeps over the whole suppression matrix (keep = no kept box before
  suppresses, one matrix-vector product a sweep), which reach the greedy
  answer exactly after at most as many sweeps as the longest chain of
  suppressions. Every eighth sweep reads one flag to stop. Extracting
  the kept indices is the op's host boundary (the output's length is
  data), as in the JAX module.
* The RoI pools gather each bin's sampling points (``roi_align``) or its
  pixels (``roi_pool``, ``psroi_pool``, within a window as large as the
  largest bin, whose size is read from the boxes) from the NHWC feature
  map, in chunks of RoIs, where the JAX module masks the whole map for
  every bin. Gradients flow through the gathers (torch autograd).
* ``deform_conv2d`` gathers the four bilinear corners of every sampling
  point with one ``gather`` each, then one grouped product, as the JAX
  module's im2col does.

``yolo_loss`` assigns the ground truth on the host (it is input data),
as the JAX module does; ``decode_jpeg`` decodes with Pillow on the host.
"""
from __future__ import annotations

import math
import sys

import numpy as np
import torch
from torch.nn import functional as TF

from ..core import dispatch
from ..core.tensor import Tensor, as_tensor
from ..nn.layer.layers import Layer
from ..ops.registry import register_module

__all__ = [
    "nms", "matrix_nms", "multiclass_nms", "roi_align", "roi_pool",
    "psroi_pool", "prior_box", "box_coder", "box_clip", "bipartite_match",
    "yolo_box", "yolo_loss", "generate_proposals",
    "distribute_fpn_proposals", "deform_conv2d", "read_file", "decode_jpeg",
    "correlation", "RoIAlign", "RoIPool", "PSRoIPool", "DeformConv2D",
]

#: values a chunk of RoIs gathers at most (about 1 GB of fp32)
_GATHER_BUDGET = 1 << 28


def _t(x) -> Tensor:
    return x if isinstance(x, Tensor) else as_tensor(x)


def _data(x) -> torch.Tensor:
    return _t(x)._data


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """a / b correctly rounded on every device. On the card a tensor
    divided by a Python number is multiplied by its reciprocal, which can
    land a unit off: enough to move a bin edge's floor or ceil, or a
    sample count's, one pixel away from the CPU's and the JAX package's."""
    return a / torch.as_tensor(b, dtype=a.dtype, device=a.device)


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(N, 4) xyxy -> (N, N) pairwise IoU (0 where the union is 0)."""
    x1, y1, x2, y2 = boxes.unbind(1)
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    ix1 = torch.maximum(x1[:, None], x1[None, :])
    iy1 = torch.maximum(y1[:, None], y1[None, :])
    ix2 = torch.minimum(x2[:, None], x2[None, :])
    iy2 = torch.minimum(y2[:, None], y2[None, :])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    union = area[:, None] + area[None, :] - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0),
                       0.0)


def _nms_keep_mask(boxes: torch.Tensor, iou_threshold: float
                   ) -> torch.Tensor:
    """Greedy NMS on boxes already in priority order -> bool keep mask,
    on the boxes' device (module docstring: sweeps to the fixed point)."""
    n = boxes.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=boxes.device)
    sup = (_iou_matrix(boxes) > iou_threshold).tril(-1).float()
    keep = torch.ones(n, dtype=torch.bool, device=boxes.device)
    for sweep in range(n):
        new = torch.mv(sup, keep.float()) == 0
        if sweep % 8 == 7 and torch.equal(new, keep):
            break
        keep = new
    return keep


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None, name=None):
    """Greedy hard NMS; the kept boxes' indices in score order (input
    order without ``scores``). With ``category_idxs`` each category is
    suppressed on its own (the boxes are moved to disjoint ranges)."""
    b = _data(boxes).float()
    n = b.shape[0]
    if scores is not None:
        order = torch.argsort(-_data(scores).float(), stable=True)
    else:
        order = torch.arange(n, device=b.device)
    if category_idxs is not None:
        cat = _data(category_idxs).to(b.device)
        span = b.max() - b.min() + 1
        b = b + (cat.to(b.dtype) * span)[:, None]
    keep = _nms_keep_mask(b[order], iou_threshold)
    kept = order[keep]                   # the host boundary: its length
    if top_k is not None:
        kept = kept[:top_k]
    return Tensor(kept)


def _detections(rows):
    """(out (M, 6) float, index) of the (class, score, box, index) rows."""
    if not rows:
        return np.zeros((0, 6), np.float32), np.zeros((0,), np.int64)
    out = np.stack([np.concatenate([[c], [sv], bx]) for c, sv, bx, _ in rows])
    return out, np.array([i for *_, i in rows], dtype=np.int64)


def _nms_outputs(outs, nums, idxs, device, return_index, return_rois_num,
                 index_dtype=None):
    out = as_tensor(np.concatenate(outs, axis=0).astype(np.float32),
                    device=device)
    res = [out]
    if return_index:
        idx = np.concatenate(idxs)
        res.append(as_tensor(idx if index_dtype is None
                             else idx.astype(index_dtype), device=device))
    if return_rois_num:
        res.append(as_tensor(np.asarray(nums, dtype=np.int32),
                             device=device))
    return tuple(res) if len(res) > 1 else out


def matrix_nms(bboxes, scores, score_threshold, post_threshold=0.0,
               nms_top_k=400, keep_top_k=200, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True,
               return_index=False, return_rois_num=True, name=None):
    """Matrix NMS (SOLOv2): each class's candidates above
    ``score_threshold`` (the best ``nms_top_k``) have their scores decayed
    by their overlaps with better boxes, all at once; detections above
    ``post_threshold``, the best ``keep_top_k`` an image. Returns (out
    (M, 6) = [label, score, x1, y1, x2, y2], [index], [rois_num])."""
    bb, sc = _data(bboxes).float(), _data(scores).float()
    if bb.dim() == 2:
        bb, sc = bb[None], sc[None]
    outs, nums, idxs = [], [], []
    for bi in range(bb.shape[0]):
        boxes_i, scores_i = bb[bi], sc[bi]
        per_det = []
        for c in range(scores_i.shape[0]):
            if c == background_label:
                continue
            s = scores_i[c]
            vidx = torch.nonzero(s > score_threshold)[:, 0]
            if vidx.numel() == 0:
                continue
            s_v, b_v = s[vidx], boxes_i[vidx]
            order = torch.argsort(-s_v, stable=True)[:nms_top_k]
            s_o, b_o = s_v[order], b_v[order]
            iou = _iou_matrix(b_o)
            n = iou.shape[0]
            tri = torch.ones(n, n, device=iou.device).tril(-1)
            iou_max_row = (iou * tri).amax(dim=1)
            if use_gaussian:
                decay = torch.exp(-(iou * tri) ** 2 / gaussian_sigma)
                comp = torch.exp(-(iou_max_row[None, :] * tri) ** 2
                                 / gaussian_sigma)
            else:
                decay = 1 - iou * tri
                comp = 1 - iou_max_row[None, :] * tri
            decay = torch.where(tri > 0, decay / torch.clamp(comp, min=1e-10),
                                1.0)
            new_s = (s_o * decay.amin(dim=1)).cpu().numpy()
            b_np = b_o.cpu().numpy()
            src = vidx[order].cpu().numpy()
            for k in range(n):
                if new_s[k] > post_threshold:
                    per_det.append((c, float(new_s[k]), b_np[k],
                                    int(src[k])))
        per_det.sort(key=lambda r: -r[1])
        out, idx = _detections(per_det[:keep_top_k])
        outs.append(out)
        nums.append(out.shape[0])
        idxs.append(idx)
    return _nms_outputs(outs, nums, idxs, bb.device, return_index,
                        return_rois_num, index_dtype=np.int32)


def multiclass_nms(bboxes, scores, score_threshold=0.0, nms_top_k=400,
                   keep_top_k=200, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=-1, return_index=False,
                   return_rois_num=True, name=None):
    """Hard NMS a class over the candidates above ``score_threshold``
    (the best ``nms_top_k``), then the best ``keep_top_k`` detections an
    image. Returns (out (M, 6), [index into the flattened batch of
    boxes], [rois_num])."""
    bb, sc = _data(bboxes).float(), _data(scores).float()
    if bb.dim() == 2:
        bb, sc = bb[None], sc[None]
    outs, nums, idxs = [], [], []
    for bi in range(bb.shape[0]):
        boxes_i, scores_i = bb[bi], sc[bi]
        dets = []
        for c in range(scores_i.shape[0]):
            if c == background_label:
                continue
            s = scores_i[c]
            valid = torch.nonzero(s > score_threshold)[:, 0]
            if valid.numel() == 0:
                continue
            s_v, b_v = s[valid], boxes_i[valid]
            order = torch.argsort(-s_v, stable=True)[:nms_top_k]
            keep = _nms_keep_mask(b_v[order], nms_threshold)
            kept = order[keep]
            s_np = s_v[kept].cpu().numpy()
            b_np = b_v[kept].cpu().numpy()
            gi = valid[kept].cpu().numpy()
            for k in range(kept.shape[0]):
                dets.append((c, float(s_np[k]), b_np[k], int(gi[k])))
        dets.sort(key=lambda r: -r[1])
        out, idx = _detections(dets[:keep_top_k])
        outs.append(out)
        nums.append(out.shape[0])
        idxs.append(idx + bi * boxes_i.shape[0])
    return _nms_outputs(outs, nums, idxs, bb.device, return_index,
                        return_rois_num)


def _roi_batch_index(boxes_num, n_rois: int, device) -> torch.Tensor:
    """Each RoI's image: ``boxes_num[i]`` RoIs of image i, in order."""
    bn = _data(boxes_num) if isinstance(boxes_num, Tensor) else \
        torch.as_tensor(np.asarray(boxes_num))
    bn = bn.to(device=device, dtype=torch.long)
    return torch.repeat_interleave(torch.arange(bn.shape[0], device=device),
                                   bn, output_size=n_rois)


def _nhwc_rows(a: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N * H * W, C): one row a pixel."""
    n, c, h, w = a.shape
    return a.permute(0, 2, 3, 1).reshape(n * h * w, c)


def _gather_pixels(rows, bidx, yi, xi, h, w):
    """Pixels (b, y, x) of the NHWC rows: ``yi``/``xi`` integer tensors
    of one shape (..., ) with ``bidx`` broadcast to it -> (..., C)."""
    lin = (bidx * h + yi) * w + xi
    return rows.index_select(0, lin.reshape(-1)).reshape(
        *lin.shape, rows.shape[1])


def _chunks(n_rois: int, per_roi: int):
    step = max(1, _GATHER_BUDGET // max(per_roi, 1))
    return range(0, n_rois, step), step


def _output_size(output_size):
    if isinstance(output_size, int):
        return output_size, output_size
    return tuple(output_size)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """RoIAlign (Mask R-CNN): each output bin is the mean of bilinear
    samples on a grid of ``sampling_ratio``^2 points (adaptive,
    ceil(bin size) a side, when it is <= 0), differentiable in x and the
    boxes."""
    x, boxes = _t(x), _t(boxes)
    ph, pw = _output_size(output_size)
    if boxes.shape[0] == 0:
        return Tensor(torch.zeros((0, x.shape[1], ph, pw),
                                  dtype=x.dtype, device=x._data.device))
    bidx_all = _roi_batch_index(boxes_num, boxes.shape[0], x._data.device)

    def f(a, rois):
        n, c, h, w = a.shape
        r_n = rois.shape[0]
        offset = 0.5 if aligned else 0.0
        x1 = rois[:, 0] * spatial_scale - offset
        y1 = rois[:, 1] * spatial_scale - offset
        x2 = rois[:, 2] * spatial_scale - offset
        y2 = rois[:, 3] * spatial_scale - offset
        rw, rh = x2 - x1, y2 - y1
        if not aligned:
            rw = torch.clamp(rw, min=1.0)
            rh = torch.clamp(rh, min=1.0)
        bin_h, bin_w = _div(rh, ph), _div(rw, pw)
        dev = a.device
        if sampling_ratio > 0:
            cap_h = cap_w = sampling_ratio
            kh = torch.arange(cap_h, device=dev)[None, None, :]
            kw = torch.arange(cap_w, device=dev)[None, None, :]
            off_h = ((kh + 0.5) / cap_h).expand(r_n, 1, cap_h)
            off_w = ((kw + 0.5) / cap_w).expand(r_n, 1, cap_w)
            wgt_h = torch.ones(r_n, 1, cap_h, device=dev)
            wgt_w = torch.ones(r_n, 1, cap_w, device=dev)
            denom = torch.full((r_n,), float(cap_h * cap_w), device=dev)
        else:
            sr_h = torch.clamp(torch.ceil(bin_h), min=1.0)
            sr_w = torch.clamp(torch.ceil(bin_w), min=1.0)
            # the grid's static size: one read of the largest count
            cap_h = max(int(sr_h.max()), 1)
            cap_w = max(int(sr_w.max()), 1)
            kh = torch.arange(cap_h, device=dev)[None, None, :]
            kw = torch.arange(cap_w, device=dev)[None, None, :]
            off_h = (kh + 0.5) / sr_h[:, None, None]
            off_w = (kw + 0.5) / sr_w[:, None, None]
            wgt_h = (kh < sr_h[:, None, None]).float()
            wgt_w = (kw < sr_w[:, None, None]).float()
            denom = sr_h * sr_w
        # sample coordinates: iy (R, ph, cap_h), ix (R, pw, cap_w)
        iy = y1[:, None, None] + bin_h[:, None, None] * (
            torch.arange(ph, device=dev)[None, :, None] + off_h)
        ix = x1[:, None, None] + bin_w[:, None, None] * (
            torch.arange(pw, device=dev)[None, :, None] + off_w)
        rows = _nhwc_rows(a)
        pieces = []
        starts, step = _chunks(r_n, ph * cap_h * pw * cap_w * c * 4)
        for s in starts:
            sl = slice(s, s + step)
            yy = iy[sl][:, :, :, None, None]          # (r, ph, sh, 1, 1)
            xx = ix[sl][:, None, None, :, :]          # (r, 1, 1, pw, sw)
            y0 = torch.clamp(torch.floor(yy), 0, h - 1)
            x0 = torch.clamp(torch.floor(xx), 0, w - 1)
            y1i = torch.clamp(y0 + 1, 0, h - 1).long()
            x1i = torch.clamp(x0 + 1, 0, w - 1).long()
            y0i, x0i = y0.long(), x0.long()
            wy1 = torch.clamp(yy, 0, h - 1) - y0
            wx1 = torch.clamp(xx, 0, w - 1) - x0
            wy0, wx0 = 1 - wy1, 1 - wx1
            ok = ((yy >= -1) & (yy <= h) & (xx >= -1) & (xx <= w)).to(a.dtype)
            b = bidx_all[sl][:, None, None, None, None]
            shape = (b.shape[0], ph, yy.shape[2], pw, xx.shape[4])

            def corner(yi, xi):
                return _gather_pixels(rows, b.expand(shape),
                                      yi.expand(shape), xi.expand(shape),
                                      h, w)
            v = (corner(y0i, x0i) * (wy0 * wx0 * ok)[..., None]
                 + corner(y0i, x1i) * (wy0 * wx1 * ok)[..., None]
                 + corner(y1i, x0i) * (wy1 * wx0 * ok)[..., None]
                 + corner(y1i, x1i) * (wy1 * wx1 * ok)[..., None])
            wgt = (wgt_h[sl][:, 0][:, None, :, None, None]
                   * wgt_w[sl][:, 0][:, None, None, None, :])
            out = (v * wgt[..., None]).sum(dim=(2, 4)) \
                / denom[sl][:, None, None, None]       # (r, ph, pw, C)
            pieces.append(out.permute(0, 3, 1, 2))
        return torch.cat(pieces)

    return dispatch.call("roi_align", f, [x, boxes])


def _bin_edges(start, size, n_bins, limit):
    """Integer bin [lo, hi) edges of n_bins bins of ``size``/n_bins from
    ``start``, clipped to [0, limit]: (R, n_bins) each."""
    k = torch.arange(n_bins, device=start.device)
    step = _div(size[:, None], n_bins)
    lo = torch.clamp(torch.floor(start[:, None] + k * step), 0, limit)
    hi = torch.clamp(torch.ceil(start[:, None] + (k + 1) * step), 0, limit)
    return lo, hi


def _window_gather(a, bidx, hs, he, ws, we, reduce_fn, per_chunk_fn=None):
    """For every RoI and bin [hs, he) x [ws, we) (each (R, bins)), the
    pixels inside a window as large as the largest bin, gathered from
    the NHWC rows with a mask of those inside the bin; ``reduce_fn(v,
    mask)`` reduces (r, ph, pw, kh, kw, C) to (r, ph, pw, C). Returns
    (R, C, ph, pw)."""
    n, c, h, w = a.shape
    r_n, ph = hs.shape
    pw = ws.shape[1]
    # the window's static size: one read of the largest bin
    kh = max(int((he - hs).max()), 1)
    kw = max(int((we - ws).max()), 1)
    rows = _nhwc_rows(a)
    dy = torch.arange(kh, device=a.device)
    dx = torch.arange(kw, device=a.device)
    pieces = []
    starts, step = _chunks(r_n, ph * pw * kh * kw * c)
    for s in starts:
        sl = slice(s, s + step)
        yy = hs[sl][:, :, None, None, None] + dy[None, None, None, :, None]
        xx = ws[sl][:, None, :, None, None] + dx[None, None, None, None, :]
        inside = (yy < he[sl][:, :, None, None, None]) \
            & (xx < we[sl][:, None, :, None, None])
        shape = (yy.shape[0], ph, pw, kh, kw)
        b = bidx[sl][:, None, None, None, None].expand(shape)
        v = _gather_pixels(rows, b,
                           torch.clamp(yy, max=h - 1).long().expand(shape),
                           torch.clamp(xx, max=w - 1).long().expand(shape),
                           h, w)
        pieces.append(reduce_fn(v, inside, sl).permute(0, 3, 1, 2))
    return torch.cat(pieces)


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0, name=None):
    """RoIPool (Fast R-CNN): the max over each bin's pixels (0 for an
    empty bin), boxes rounded to the feature grid."""
    x, boxes = _t(x), _t(boxes)
    ph, pw = _output_size(output_size)
    bidx = _roi_batch_index(boxes_num, boxes.shape[0], x._data.device)

    def f(a, rois):
        n, c, h, w = a.shape
        x1 = torch.round(rois[:, 0] * spatial_scale)
        y1 = torch.round(rois[:, 1] * spatial_scale)
        x2 = torch.round(rois[:, 2] * spatial_scale)
        y2 = torch.round(rois[:, 3] * spatial_scale)
        rw = torch.clamp(x2 - x1 + 1, min=1.0)
        rh = torch.clamp(y2 - y1 + 1, min=1.0)
        hs, he = _bin_edges(y1, rh, ph, h)
        ws, we = _bin_edges(x1, rw, pw, w)
        neg = torch.finfo(a.dtype).min

        def reduce_fn(v, inside, sl):
            m = inside[..., None]
            out = torch.where(m, v, neg).amax(dim=(3, 4))
            return torch.where(m.any(dim=(3, 4)), out, 0.0)
        return _window_gather(a, bidx, hs.long(), he.long(), ws.long(),
                              we.long(), reduce_fn)

    return dispatch.call("roi_pool", f, [x, boxes])


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive RoI average pool (R-FCN): with C = out_c * ph *
    pw input channels, output bin (i, j) of channel k averages input
    channel (k, i, j) over the bin (0 for an empty bin)."""
    x, boxes = _t(x), _t(boxes)
    ph, pw = _output_size(output_size)
    bidx = _roi_batch_index(boxes_num, boxes.shape[0], x._data.device)

    def f(a, rois):
        n, c, h, w = a.shape
        out_c = c // (ph * pw)
        # rounded in input coordinates, then scaled
        x1 = torch.round(rois[:, 0]) * spatial_scale
        y1 = torch.round(rois[:, 1]) * spatial_scale
        x2 = (torch.round(rois[:, 2]) + 1) * spatial_scale
        y2 = (torch.round(rois[:, 3]) + 1) * spatial_scale
        rw = torch.clamp(x2 - x1, min=0.1)
        rh = torch.clamp(y2 - y1, min=0.1)
        hs, he = _bin_edges(y1, rh, ph, h)
        ws, we = _bin_edges(x1, rw, pw, w)
        ii = torch.arange(ph, device=a.device)[:, None]
        jj = torch.arange(pw, device=a.device)[None, :]

        def reduce_fn(v, inside, sl):
            # v (r, ph, pw, kh, kw, C): bin (i, j) keeps channels (k, i, j)
            v = v.reshape(*v.shape[:5], out_c, ph, pw)
            v = v[:, ii, jj, :, :, :, ii, jj]          # (ph, pw, r, ...)
            v = v.permute(2, 0, 1, 3, 4, 5)            # (r, ph, pw, kh, kw, k)
            m = inside[..., None].to(v.dtype)
            cnt = m.sum(dim=(3, 4))
            total = (v * m).sum(dim=(3, 4))
            return torch.where(cnt > 0, total / torch.clamp(cnt, min=1),
                               0.0)
        return _window_gather(a, bidx, hs.long(), he.long(), ws.long(),
                              we.long(), reduce_fn)

    return dispatch.call("psroi_pool", f, [x, boxes])


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, min_max_aspect_ratios_order=False,
              name=None):
    """SSD anchors: (boxes (H, W, P, 4) normalized xyxy, variances of
    the same shape) for the feature map ``input`` over ``image``, on
    ``input``'s device."""
    input, image = _t(input), _t(image)
    fh, fw = input.shape[2], input.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    step_h = steps[1] if steps[1] > 0 else ih / fh
    step_w = steps[0] if steps[0] > 0 else iw / fw
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - e) < 1e-6 for e in ars):
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)
    boxes = []
    for s in min_sizes:
        sizes = []
        if min_max_aspect_ratios_order:
            sizes.append((s, s))
            if max_sizes:
                mx = max_sizes[min_sizes.index(s)]
                sizes.append((np.sqrt(s * mx), np.sqrt(s * mx)))
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                sizes.append((s * np.sqrt(ar), s / np.sqrt(ar)))
        else:
            for ar in ars:
                sizes.append((s * np.sqrt(ar), s / np.sqrt(ar)))
            if max_sizes:
                mx = max_sizes[min_sizes.index(s)]
                sizes.append((np.sqrt(s * mx), np.sqrt(s * mx)))
        boxes.extend(sizes)
    cx = (np.arange(fw) + offset) * step_w
    cy = (np.arange(fh) + offset) * step_h
    gx, gy = np.meshgrid(cx, cy)
    out = np.zeros((fh, fw, len(boxes), 4), dtype=np.float32)
    for k, (bw, bh) in enumerate(boxes):
        out[:, :, k, 0] = (gx - bw / 2) / iw
        out[:, :, k, 1] = (gy - bh / 2) / ih
        out[:, :, k, 2] = (gx + bw / 2) / iw
        out[:, :, k, 3] = (gy + bh / 2) / ih
    if clip:
        out = np.clip(out, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, dtype=np.float32),
                          out.shape).copy()
    dev = input._data.device
    return as_tensor(out, device=dev), as_tensor(var, device=dev)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0,
              name=None):
    """The R-CNN box codec: "encode_center_size" gives the (M, N, 4)
    deltas of M boxes against N priors; "decode_center_size" decodes
    deltas against the priors (broadcast on ``axis``). No gradient, as
    in the JAX module."""
    pb = _data(prior_box).float().detach()
    tb = _data(target_box).float().detach().to(pb.device)
    pbv = None
    if prior_box_var is not None:
        if isinstance(prior_box_var, (list, tuple)):
            pbv = torch.tensor(prior_box_var, dtype=torch.float32,
                               device=pb.device)
        else:
            pbv = _data(prior_box_var).float().detach().to(pb.device)
    norm = 0.0 if box_normalized else 1.0
    pw = pb[:, 2] - pb[:, 0] + norm
    ph_ = pb[:, 3] - pb[:, 1] + norm
    pcx = pb[:, 0] + pw / 2
    pcy = pb[:, 1] + ph_ / 2
    if code_type == "encode_center_size":
        tw = tb[:, 2] - tb[:, 0] + norm
        th = tb[:, 3] - tb[:, 1] + norm
        tcx = tb[:, 0] + tw / 2
        tcy = tb[:, 1] + th / 2
        dx = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        dy = (tcy[:, None] - pcy[None, :]) / ph_[None, :]
        dw = torch.log(tw[:, None] / pw[None, :])
        dh = torch.log(th[:, None] / ph_[None, :])
        out = torch.stack([dx, dy, dw, dh], dim=-1)
        if pbv is not None:
            out = out / (pbv if pbv.dim() == 1 else pbv[None, :, :])
        return Tensor(out)
    if tb.dim() == 2:
        tb = tb[:, None, :]
    if axis == 0:
        pcx_b, pcy_b = pcx[:, None], pcy[:, None]
        pw_b, ph_b = pw[:, None], ph_[:, None]
        if pbv is not None and pbv.dim() == 2:
            pbv = pbv[:, None, :]
    else:
        pcx_b, pcy_b = pcx[None, :], pcy[None, :]
        pw_b, ph_b = pw[None, :], ph_[None, :]
        if pbv is not None and pbv.dim() == 2:
            pbv = pbv[None, :, :]
    d = tb if pbv is None else tb * pbv
    cx = d[..., 0] * pw_b + pcx_b
    cy = d[..., 1] * ph_b + pcy_b
    w_ = torch.exp(d[..., 2]) * pw_b
    h_ = torch.exp(d[..., 3]) * ph_b
    return Tensor(torch.stack([cx - w_ / 2, cy - h_ / 2,
                               cx + w_ / 2 - norm, cy + h_ / 2 - norm],
                              dim=-1))


def box_clip(input, im_info, name=None):
    """Clip xyxy boxes to the image of ``im_info`` [h, w, scale]."""
    info = _data(im_info).float().detach()

    def f(boxes):
        inf = info.to(boxes.device)
        h = (inf[..., 0] / inf[..., 2] - 1)
        w = (inf[..., 1] / inf[..., 2] - 1)
        x1 = torch.minimum(torch.clamp(boxes[..., 0], min=0), w)
        y1 = torch.minimum(torch.clamp(boxes[..., 1], min=0), h)
        x2 = torch.minimum(torch.clamp(boxes[..., 2], min=0), w)
        y2 = torch.minimum(torch.clamp(boxes[..., 3], min=0), h)
        return torch.stack([x1, y1, x2, y2], dim=-1)

    return dispatch.call("box_clip", f, [_t(input)])


def bipartite_match(dist_matrix, match_type="bipartite", dist_threshold=0.5,
                    name=None):
    """Greedy bipartite matching of rows (ground truth) to columns
    (priors): min(rows, cols) rounds of the global maximum, its row and
    column then struck out. Returns (match_indices (1, cols), -1 where
    unmatched; match_dist (1, cols)); "per_prediction" also gives each
    unmatched column its best row at ``dist_threshold`` or above."""

    def f(d):
        nr, nc = d.shape
        work = d
        midx = torch.full((nc,), -1, dtype=torch.int32, device=d.device)
        mdist = torch.zeros(nc, dtype=d.dtype, device=d.device)
        rows = torch.arange(nr, device=d.device)[:, None]
        cols = torch.arange(nc, device=d.device)
        for _ in range(min(nr, nc)):
            flat = torch.argmax(work)
            r, c = flat // nc, flat % nc
            v = work.reshape(-1)[flat]
            take = v > 0
            struck = torch.where((rows == r) | (cols == c)[None, :], -1.0,
                                 work)
            work = torch.where(take, struck, work)
            at_c = (cols == c) & take
            midx = torch.where(at_c, r.to(torch.int32), midx)
            mdist = torch.where(at_c, v, mdist)
        if match_type == "per_prediction":
            best_v, best_r = d.max(dim=0)
            fill = (midx == -1) & (best_v >= dist_threshold)
            midx = torch.where(fill, best_r.to(torch.int32), midx)
            mdist = torch.where(fill, best_v, mdist)
        return midx[None], mdist[None]

    return dispatch.call("bipartite_match", f, [_t(dist_matrix)])


def yolo_box(x, img_size, anchors, class_num, conf_thresh, downsample_ratio,
             clip_bbox=True, scale_x_y=1.0, iou_aware=False,
             iou_aware_factor=0.5, name=None):
    """Decode a YOLOv3 head (N, A*(5+C), H, W) into (boxes (N, A*H*W, 4)
    in image pixels, scores (N, A*H*W, C)), both 0 below
    ``conf_thresh``. With ``iou_aware`` the A IoU channels lead."""
    x = _t(x)
    imgs = _data(img_size).float().detach()
    anchors = np.asarray(anchors, dtype=np.float32).reshape(-1, 2)
    na = anchors.shape[0]

    def f(a):
        n, _, h, w = a.shape
        dev = a.device
        anc = torch.as_tensor(anchors, device=dev)
        if iou_aware:
            ioup = torch.sigmoid(a[:, :na])
            a = a[:, na:].reshape(n, na, -1, h, w)
        else:
            a = a.reshape(n, na, -1, h, w)
        gx = torch.arange(w, dtype=torch.float32, device=dev)
        gy = torch.arange(h, dtype=torch.float32, device=dev)
        bx = ((torch.sigmoid(a[:, :, 0]) - 0.5) * scale_x_y + 0.5
              + gx[None, None, None, :]) / w
        by = ((torch.sigmoid(a[:, :, 1]) - 0.5) * scale_x_y + 0.5
              + gy[None, None, :, None]) / h
        in_w = downsample_ratio * w
        in_h = downsample_ratio * h
        bw = torch.exp(a[:, :, 2]) * anc[None, :, 0, None, None] / in_w
        bh = torch.exp(a[:, :, 3]) * anc[None, :, 1, None, None] / in_h
        conf = torch.sigmoid(a[:, :, 4])
        if iou_aware:
            conf = conf ** (1 - iou_aware_factor) * ioup ** iou_aware_factor
        cls = torch.sigmoid(a[:, :, 5:])
        score = conf[:, :, None] * cls
        keep = (conf >= conf_thresh).to(a.dtype)
        im = imgs.to(dev)
        imw = im[:, 1][:, None, None, None]
        imh = im[:, 0][:, None, None, None]
        x1 = (bx - bw / 2) * imw
        y1 = (by - bh / 2) * imh
        x2 = (bx + bw / 2) * imw
        y2 = (by + bh / 2) * imh
        if clip_bbox:
            x1 = torch.minimum(torch.clamp(x1, min=0), imw - 1)
            y1 = torch.minimum(torch.clamp(y1, min=0), imh - 1)
            x2 = torch.minimum(torch.clamp(x2, min=0), imw - 1)
            y2 = torch.minimum(torch.clamp(y2, min=0), imh - 1)
        boxes = torch.stack([x1, y1, x2, y2], dim=2) * keep[:, :, None]
        scores = score * keep[:, :, None]
        boxes = boxes.permute(0, 1, 3, 4, 2).reshape(n, -1, 4)
        scores = scores.permute(0, 1, 3, 4, 2).reshape(n, -1, cls.shape[2])
        return boxes, scores

    return dispatch.call("yolo_box", f, [x])


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, scale_x_y=1.0, name=None):
    """YOLOv3's training loss an image (N,): box centre BCE and size L1
    (scaled by 2 - w*h), objectness BCE (predictions overlapping a
    ground truth above ``ignore_thresh`` ignored) and class BCE.
    Differentiable in x. The ground truth (cx, cy, w, h normalized) is
    assigned to its best anchor's cell on the host."""
    x = _t(x)
    gtb = _data(gt_box).detach().float().cpu().numpy()
    gtl = _data(gt_label).detach().cpu().numpy()
    gts = (_data(gt_score).detach().float().cpu().numpy()
           if gt_score is not None else np.ones(gtl.shape, np.float32))
    anchors_np = np.asarray(anchors, dtype=np.float32).reshape(-1, 2)
    mask = list(anchor_mask)
    na = len(mask)
    n, _, h, w = x.shape
    in_w = downsample_ratio * w
    in_h = downsample_ratio * h
    tobj = np.zeros((n, na, h, w), np.float32)
    tscale = np.zeros((n, na, h, w), np.float32)
    ttxy = np.zeros((n, na, 2, h, w), np.float32)
    ttwh = np.zeros((n, na, 2, h, w), np.float32)
    tcls = np.zeros((n, na, class_num, h, w), np.float32)
    gt_xyxy = []
    for b in range(n):
        boxes_img = []
        for t in range(gtb.shape[1]):
            cx, cy, bw, bh = gtb[b, t]
            if bw <= 0 or bh <= 0:
                continue
            boxes_img.append([cx - bw / 2, cy - bh / 2,
                              cx + bw / 2, cy + bh / 2])
            inter = (np.minimum(anchors_np[:, 0], bw * in_w)
                     * np.minimum(anchors_np[:, 1], bh * in_h))
            union = (anchors_np[:, 0] * anchors_np[:, 1]
                     + bw * in_w * bh * in_h - inter)
            best = int(np.argmax(inter / np.maximum(union, 1e-10)))
            if best not in mask:
                continue
            k = mask.index(best)
            gi = min(int(cx * w), w - 1)
            gj = min(int(cy * h), h - 1)
            tobj[b, k, gj, gi] = gts[b, t]
            tscale[b, k, gj, gi] = 2.0 - bw * bh
            ttxy[b, k, 0, gj, gi] = cx * w - gi
            ttxy[b, k, 1, gj, gi] = cy * h - gj
            ttwh[b, k, 0, gj, gi] = np.log(
                max(bw * in_w / anchors_np[best, 0], 1e-9))
            ttwh[b, k, 1, gj, gi] = np.log(
                max(bh * in_h / anchors_np[best, 1], 1e-9))
            lbl = int(gtl[b, t])
            smooth = (1.0 / class_num if use_label_smooth and class_num > 1
                      else 0.0)
            tcls[b, k, :, gj, gi] = smooth
            tcls[b, k, lbl, gj, gi] = (1.0 - smooth if use_label_smooth
                                       else 1.0)
        gt_xyxy.append(np.asarray(boxes_img, np.float32).reshape(-1, 4))
    maxg = max((g.shape[0] for g in gt_xyxy), default=0)
    gt_pad = np.zeros((n, max(maxg, 1), 4), np.float32)
    gt_valid = np.zeros((n, max(maxg, 1)), np.float32)
    for b, g in enumerate(gt_xyxy):
        gt_pad[b, :g.shape[0]] = g
        gt_valid[b, :g.shape[0]] = 1.0
    masked_anchors = anchors_np[mask]

    def f(a):
        dev = a.device

        def on(arr):
            return torch.as_tensor(arr, device=dev)
        a = a.reshape(n, na, 5 + class_num, h, w)
        px = torch.sigmoid(a[:, :, 0])
        py = torch.sigmoid(a[:, :, 1])
        pw_, ph_ = a[:, :, 2], a[:, :, 3]
        pobj, pcls = a[:, :, 4], a[:, :, 5:]
        obj = on(tobj)
        sc = on(tscale) * obj

        def bce(z, t, from_logits):
            if from_logits:
                return (torch.clamp(z, min=0) - z * t
                        + torch.log1p(torch.exp(-z.abs())))
            p = torch.clamp(z, 1e-7, 1 - 1e-7)
            return -(t * torch.log(p) + (1 - t) * torch.log(1 - p))

        txy, twh = on(ttxy), on(ttwh)
        loss_xy = (bce(px, txy[:, :, 0], False)
                   + bce(py, txy[:, :, 1], False)) * sc
        loss_wh = ((pw_ - twh[:, :, 0]).abs()
                   + (ph_ - twh[:, :, 1]).abs()) * sc
        # ignored: predictions overlapping a ground truth above the bar
        anc = on(masked_anchors)
        gx = (px + torch.arange(w, device=dev)[None, None, None, :]) / w
        gy = (py + torch.arange(h, device=dev)[None, None, :, None]) / h
        gw = torch.exp(pw_) * anc[None, :, 0, None, None] / in_w
        gh = torch.exp(ph_) * anc[None, :, 1, None, None] / in_h
        p1x, p1y = gx - gw / 2, gy - gh / 2
        p2x, p2y = gx + gw / 2, gy + gh / 2
        gtp = on(gt_pad)
        gv = on(gt_valid)
        ix1 = torch.maximum(p1x[..., None], gtp[:, None, None, None, :, 0])
        iy1 = torch.maximum(p1y[..., None], gtp[:, None, None, None, :, 1])
        ix2 = torch.minimum(p2x[..., None], gtp[:, None, None, None, :, 2])
        iy2 = torch.minimum(p2y[..., None], gtp[:, None, None, None, :, 3])
        inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
        area_p = (gw * gh)[..., None]
        area_g = ((gtp[:, :, 2] - gtp[:, :, 0])
                  * (gtp[:, :, 3] - gtp[:, :, 1]))[:, None, None, None, :]
        iou = inter / torch.clamp(area_p + area_g - inter, min=1e-10)
        best_iou = (iou * gv[:, None, None, None, :]).amax(dim=-1)
        ignore = (best_iou > ignore_thresh) & (obj == 0)
        obj_mask = torch.where(ignore, 0.0, 1.0)
        loss_obj = bce(pobj, obj, True) * obj_mask
        loss_cls = (bce(pcls, on(tcls), True) * obj[:, :, None]).sum(dim=2)
        total = loss_xy + loss_wh + loss_obj + loss_cls
        return total.sum(dim=(1, 2, 3))

    return dispatch.call("yolo_loss", f, [x])


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=True, name=None):
    """RPN proposals an image: the best ``pre_nms_top_n`` anchors by
    score, decoded with their deltas, clipped to the image, those at
    least ``min_size`` a side, NMS at ``nms_thresh``, the best
    ``post_nms_top_n``. Returns (rois, scores[, rois_num])."""
    sc = _data(scores).float()                     # (N, A, H, W)
    dev = sc.device
    bd = _data(bbox_deltas).float().to(dev)        # (N, 4A, H, W)
    ims = _data(img_size).float().to(dev)          # (N, 2) h, w
    anc = _data(anchors).float().to(dev).reshape(-1, 4)
    var = _data(variances).float().to(dev).reshape(-1, 4)
    offset = 1.0 if pixel_offset else 0.0

    def decode(s_map, d_map, im):
        s = s_map.permute(1, 2, 0).reshape(-1)
        d = d_map.reshape(-1, 4, s_map.shape[1], s_map.shape[2])
        d = d.permute(2, 3, 0, 1).reshape(-1, 4)
        order = torch.argsort(-s, stable=True)[:pre_nms_top_n]
        s, d = s[order], d[order]
        a, v = anc[order], var[order]
        aw = a[:, 2] - a[:, 0] + offset
        ah = a[:, 3] - a[:, 1] + offset
        acx = a[:, 0] + aw / 2
        acy = a[:, 1] + ah / 2
        cx = v[:, 0] * d[:, 0] * aw + acx
        cy = v[:, 1] * d[:, 1] * ah + acy
        w_ = torch.exp(torch.clamp(v[:, 2] * d[:, 2], max=10.0)) * aw
        h_ = torch.exp(torch.clamp(v[:, 3] * d[:, 3], max=10.0)) * ah
        props = torch.stack([cx - w_ / 2, cy - h_ / 2,
                             cx + w_ / 2 - offset, cy + h_ / 2 - offset],
                            dim=1)
        imh, imw = im[0], im[1]
        hi = torch.stack([imw - offset, imh - offset,
                          imw - offset, imh - offset])
        props = torch.minimum(torch.clamp(props, min=0), hi)
        ws = props[:, 2] - props[:, 0] + offset
        hs = props[:, 3] - props[:, 1] + offset
        return props, s, (ws >= min_size) & (hs >= min_size)

    all_rois, all_scores, nums = [], [], []
    for b in range(sc.shape[0]):
        props, s, valid = decode(sc[b], bd[b], ims[b])
        vidx = torch.nonzero(valid)[:, 0]          # the host boundary
        keep = _nms_keep_mask(props[vidx], nms_thresh)
        kept = vidx[keep][:post_nms_top_n]
        all_rois.append(props[kept])
        all_scores.append(s[kept])
        nums.append(int(kept.shape[0]))
    rois = Tensor(torch.cat(all_rois, 0))
    rscores = Tensor(torch.cat(all_scores, 0))
    if return_rois_num:
        return rois, rscores, as_tensor(np.asarray(nums, dtype=np.int32),
                                        device=dev)
    return rois, rscores


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False, rois_num=None,
                             name=None):
    """Assign RoIs to FPN levels by scale (level = refer_level +
    floor(log2(sqrt(area) / refer_scale)), clipped). Returns (the RoIs
    of each level, the restore index (R, 1)[, each level's count])."""
    rois_t = _data(fpn_rois).float()
    dev = rois_t.device
    offset = 1.0 if pixel_offset else 0.0
    ws = rois_t[:, 2] - rois_t[:, 0] + offset
    hs = rois_t[:, 3] - rois_t[:, 1] + offset
    scale = torch.sqrt(torch.clamp(ws * hs, min=0))
    ratio = _div(scale, refer_scale)
    lvl = torch.clamp(torch.floor(torch.log2(ratio + 1e-8)) + refer_level,
                      min_level, max_level).long()
    multi_rois, rois_num_per = [], []
    restore = torch.zeros(rois_t.shape[0], dtype=torch.long, device=dev)
    pos = 0
    for level in range(min_level, max_level + 1):
        idx = torch.nonzero(lvl == level)[:, 0]    # the host boundary
        k = int(idx.shape[0])
        multi_rois.append(Tensor(rois_t[idx]))
        restore[idx] = torch.arange(pos, pos + k, device=dev)
        rois_num_per.append(as_tensor(np.asarray([k], dtype=np.int32),
                                      device=dev))
        pos += k
    restore_t = as_tensor(restore[:, None])
    if rois_num is not None:
        return multi_rois, restore_t, rois_num_per
    return multi_rois, restore_t


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1 (v2 with ``mask``): each kernel tap reads
    x bilinearly at its offset (0 outside the map), then one grouped
    product with the weight. x (N, Cin, H, W); offset (N, 2*dg*kh*kw, Ho,
    Wo) as (dy, dx) pairs; mask (N, dg*kh*kw, Ho, Wo)."""
    x, offset, weight = _t(x), _t(offset), _t(weight)
    tensors = [x, offset, weight]
    if mask is not None:
        tensors.append(_t(mask))
    if bias is not None:
        tensors.append(_t(bias))
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    p = (padding, padding) if isinstance(padding, int) else tuple(padding)
    dil = (dilation, dilation) if isinstance(dilation, int) \
        else tuple(dilation)

    def f(a, off, w_, *rest):
        m = rest[0] if mask is not None else None
        bval = rest[-1] if bias is not None else None
        n, cin, h, wid = a.shape
        cout, cin_g, kh, kw = w_.shape
        dg = deformable_groups
        kk = kh * kw
        dev = a.device
        ho = (h + 2 * p[0] - (dil[0] * (kh - 1) + 1)) // s[0] + 1
        wo = (wid + 2 * p[1] - (dil[1] * (kw - 1) + 1)) // s[1] + 1
        off = off.reshape(n, dg, kk, 2, ho, wo)
        base_y = (torch.arange(ho, device=dev)[None, :, None] * s[0] - p[0]
                  + torch.arange(kh, device=dev)[:, None, None] * dil[0])
        base_y = base_y[:, None].expand(kh, kw, ho, wo).reshape(kk, ho, wo)
        base_x = (torch.arange(wo, device=dev)[None, :] * s[1] - p[1]
                  + torch.arange(kw, device=dev)[:, None] * dil[1])
        base_x = base_x[None, :, None, :].expand(kh, kw, ho, wo).reshape(
            kk, ho, wo)
        py = base_y.to(a.dtype) + off[:, :, :, 0]     # (n, dg, kk, ho, wo)
        px = base_x.to(a.dtype) + off[:, :, :, 1]
        cpg = cin // dg
        img = a.reshape(n, dg, cpg, h * wid)
        y0, x0 = torch.floor(py), torch.floor(px)
        wy1, wx1 = py - y0, px - x0
        length = kk * ho * wo
        cols = 0.0
        for dy, wy in ((0, 1 - wy1), (1, wy1)):
            for dx, wx in ((0, 1 - wx1), (1, wx1)):
                yi = (y0 + dy).long()
                xi = (x0 + dx).long()
                ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < wid)
                lin = (torch.clamp(yi, 0, h - 1) * wid
                       + torch.clamp(xi, 0, wid - 1)).reshape(n, dg, 1,
                                                              length)
                g = torch.gather(img, 3, lin.expand(n, dg, cpg, length))
                wgt = (wy * wx * ok.to(a.dtype)).reshape(n, dg, 1, length)
                cols = cols + g * wgt
        cols = cols.reshape(n, cin, kk, ho, wo)
        if m is not None:
            mm = m.reshape(n, dg, 1, kk, ho, wo).expand(
                n, dg, cpg, kk, ho, wo).reshape(n, cin, kk, ho, wo)
            cols = cols * mm
        wmat = w_.reshape(groups, cout // groups, cin_g * kk)
        cols = cols.reshape(n, groups, cin_g * kk, ho * wo)
        out = torch.einsum("gok,ngkp->ngop", wmat, cols).reshape(
            n, cout, ho, wo)
        if bval is not None:
            out = out + bval.reshape(1, -1, 1, 1)
        return out

    return dispatch.call("deform_conv2d", f, tensors)


def correlation(x1, x2, pad_size, kernel_size, max_displacement, stride1,
                stride2, corr_type_multiply=1, name=None):
    """FlowNet correlation: for each displacement (di, dj) on the
    ``stride2`` grid within ``max_displacement``, the channel mean of
    x1 * x2 shifted, averaged over a ``kernel_size`` patch; output
    positions are those whose displaced patch stays inside the padded
    map, every ``stride1``-th."""
    if kernel_size % 2 != 1:
        raise ValueError("correlation: kernel_size must be odd")
    d = max_displacement // stride2
    r = (kernel_size - 1) // 2
    border = max_displacement + r
    if pad_size < border:
        raise ValueError(
            f"correlation: pad_size {pad_size} must cover "
            f"max_displacement + (kernel_size-1)//2 = {border}")

    def f(a, b):
        n, c, h, w = a.shape
        ap = TF.pad(a, (pad_size,) * 4)
        bp = TF.pad(b, (pad_size,) * 4)
        hp, wp = h + 2 * pad_size, w + 2 * pad_size
        eh, ew = hp - 2 * border, wp - 2 * border
        base = ap[:, :, border - r:border + eh + r,
                  border - r:border + ew + r]
        outs = []
        for di in range(-d, d + 1):
            for dj in range(-d, d + 1):
                oy, ox = di * stride2, dj * stride2
                shifted = bp[:, :, border + oy - r:border + oy + eh + r,
                             border + ox - r:border + ox + ew + r]
                prod = (base * shifted).mean(dim=1)
                if r:
                    prod = TF.avg_pool2d(prod[:, None], kernel_size, 1)[:, 0]
                outs.append(prod)
        return torch.stack(outs, dim=1)[:, :, ::stride1, ::stride1]

    return dispatch.call("correlation", f, [_t(x1), _t(x2)])


def read_file(filename, name=None):
    """The file's bytes as a uint8 Tensor (on the current device)."""
    with open(filename, "rb") as fh:
        data = np.frombuffer(fh.read(), dtype=np.uint8).copy()
    return as_tensor(data)


def decode_jpeg(x, mode="unchanged", name=None):
    """Decode JPEG bytes (a uint8 Tensor) to a (C, H, W) uint8 Tensor with
    Pillow on the host; ``mode`` "gray" or "rgb" converts."""
    import io as _io

    from PIL import Image
    t = _data(x)
    raw = bytes(t.detach().cpu().numpy().astype(np.uint8))
    img = Image.open(_io.BytesIO(raw))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img)
    arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return as_tensor(np.ascontiguousarray(arr), device=t.device)


class RoIAlign(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_align(x, boxes, boxes_num, self.output_size,
                         self.spatial_scale)


class RoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self.output_size,
                        self.spatial_scale)


class PSRoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self.output_size,
                          self.spatial_scale)


class DeformConv2D(Layer):
    """A deformable convolution layer: ``forward(x, offset, mask=None)``;
    weight and bias uniform in +-1/sqrt(fan_in)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        from ..nn import initializer
        kh, kw = ((kernel_size, kernel_size)
                  if isinstance(kernel_size, int) else kernel_size)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.deformable_groups, self.groups = deformable_groups, groups
        k = 1.0 / math.sqrt(in_channels * kh * kw)
        self.weight = self.create_parameter(
            (out_channels, in_channels // groups, kh, kw),
            default_initializer=initializer.Uniform(-k, k))
        if bias_attr is not False:
            self.bias = self.create_parameter(
                (out_channels,), is_bias=True,
                default_initializer=initializer.Uniform(-k, k))
        else:
            self.bias = None

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias, self.stride,
                             self.padding, self.dilation,
                             self.deformable_groups, self.groups, mask)

register_module(sys.modules[__name__], "vision")
