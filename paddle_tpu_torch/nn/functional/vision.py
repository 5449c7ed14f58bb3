"""Sampling-grid functionals (counterpart of
``paddle_tpu/nn/functional/vision.py``): ``affine_grid``,
``grid_sample`` (bilinear or nearest; zeros, border or reflection
padding) and ``temporal_shift``, as gathers and lerps that autograd
differentiates into both the feature map and the grid."""
from __future__ import annotations


import torch

from ._op import call

__all__ = ["affine_grid", "grid_sample", "temporal_shift"]


def _axis(size, align_corners, dtype, device):
    if align_corners:
        return torch.linspace(-1.0, 1.0, size, dtype=dtype, device=device)
    return (torch.arange(size, dtype=dtype, device=device) * 2 + 1) / size - 1


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """Sampling grid of batched affine maps: theta (N, 2, 3) -> (N, H, W,
    2), or (N, 3, 4) -> (N, D, H, W, 3), over [-1, 1] coordinates."""
    shape = [int(s) for s in out_shape]

    def body(th):
        dt, dev = th.dtype, th.device
        if tuple(th.shape[-2:]) == (2, 3):
            n, _, h, w = shape
            gy, gx = torch.meshgrid(_axis(h, align_corners, dt, dev),
                                    _axis(w, align_corners, dt, dev),
                                    indexing="ij")
            base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
            return torch.einsum("hwk,nck->nhwc", base, th)
        n, _, d, h, w = shape
        gz, gy, gx = torch.meshgrid(_axis(d, align_corners, dt, dev),
                                    _axis(h, align_corners, dt, dev),
                                    _axis(w, align_corners, dt, dev),
                                    indexing="ij")
        base = torch.stack([gx, gy, gz, torch.ones_like(gx)], dim=-1)
        return torch.einsum("dhwk,nck->ndhwc", base, th)
    return call("affine_grid", body, [theta])


def _unnormalize(coord, size, align_corners):
    if align_corners:
        return (coord + 1) * 0.5 * (size - 1)
    return ((coord + 1) * size - 1) * 0.5


def _reflect(coord, size, align_corners):
    """Reflection about the pixel centres (``align_corners``) or the
    borders."""
    if align_corners:
        span = 2 * (size - 1)
        if span == 0:
            return torch.zeros_like(coord)
        coord = coord.abs() % span
        return torch.where(coord > size - 1, span - coord, coord)
    span = 2 * size
    coord = (coord + 0.5).abs() % span
    coord = torch.where(coord > size, span - coord, coord)
    return (coord - 0.5).clamp(0, size - 1)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample x (N, C, H, W) at the normalized (N, Hg, Wg, 2) grid
    (x then y, in [-1, 1]): bilinear or nearest (half to even), with
    zeros, border or reflection padding."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"grid_sample mode must be bilinear|nearest, "
                         f"got {mode}")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"unsupported padding_mode {padding_mode}")

    def body(a, g):
        n, _, h, w = a.shape
        ix = _unnormalize(g[..., 0], w, align_corners)
        iy = _unnormalize(g[..., 1], h, align_corners)
        if padding_mode == "border":
            ix, iy = ix.clamp(0, w - 1), iy.clamp(0, h - 1)
        elif padding_mode == "reflection":
            ix, iy = (_reflect(ix, w, align_corners),
                      _reflect(iy, h, align_corners))
        batch = torch.arange(n, device=a.device).reshape(n, 1, 1)

        def gather(yi, xi):
            vals = a.permute(0, 2, 3, 1)[batch, yi.clamp(0, h - 1),
                                         xi.clamp(0, w - 1)]
            if padding_mode == "zeros":
                ok = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
                vals = vals * ok[..., None].to(vals.dtype)
            return vals.movedim(-1, 1)

        if mode == "nearest":
            return gather(torch.round(iy).long(), torch.round(ix).long())
        x0, y0 = torch.floor(ix), torch.floor(iy)
        wx1, wy1 = (ix - x0).to(g.dtype), (iy - y0).to(g.dtype)
        wx0, wy0 = 1 - wx1, 1 - wy1
        x0i, y0i = x0.long(), y0.long()
        x1i, y1i = x0i + 1, y0i + 1
        return (gather(y0i, x0i) * (wy0 * wx0)[:, None]
                + gather(y0i, x1i) * (wy0 * wx1)[:, None]
                + gather(y1i, x0i) * (wy1 * wx0)[:, None]
                + gather(y1i, x1i) * (wy1 * wx1)[:, None])
    return call("grid_sample", body, [x, grid])


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM's shift of (N T, C, H, W): the first ``shift_ratio`` of the
    channels one step back in time, the next as many one step forward,
    the rest unchanged; zeros shift in."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"unsupported data_format {data_format}")

    def body(a):
        if data_format == "NHWC":
            a = a.permute(0, 3, 1, 2)
        nt, c, h, w = a.shape
        t = seg_num
        c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
        v = a.reshape(nt // t, t, c, h, w)
        pad = torch.zeros_like(v[:, :1])
        back = torch.cat([v[:, 1:, :c1], pad[:, :, :c1]], dim=1)
        fwd = torch.cat([pad[:, :, c1:c2], v[:, :-1, c1:c2]], dim=1)
        out = torch.cat([back, fwd, v[:, :, c2:]], dim=2).reshape(nt, c, h, w)
        return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out
    return call("temporal_shift", body, [x])

