"""paddle.signal: ``frame``, ``overlap_add``, ``stft`` and ``istft``
(counterpart of ``paddle_tpu/signal.py``). Framing is a strided view
(``unfold``), overlap-add an ``index_add``, the transforms
``torch.fft``'s; all behind ``dispatch.call`` and differentiable.
"""
from __future__ import annotations

import sys

import torch
import torch.nn.functional as TF

from .core import dispatch
from .core.tensor import Tensor, as_tensor
from .ops.registry import register_module


def _t(x):
    return x if isinstance(x, Tensor) else as_tensor(x)


def frame(x, frame_length: int, hop_length: int, axis: int = -1,
          name=None):
    """Overlapping frames along ``axis``: [..., seq] -> [..., frame_length,
    num_frames] for axis -1, [seq, ...] -> [num_frames, frame_length, ...]
    for axis 0."""
    def f(a):
        seq = a.shape[axis]
        if frame_length > seq:
            raise ValueError("frame_length must be <= sequence length")
        frames = a.movedim(axis, -1).unfold(-1, frame_length, hop_length)
        if axis == 0:                       # [num_frames, fl, ...]
            return frames.movedim((-2, -1), (0, 1)).contiguous()
        if axis in (-1, a.dim() - 1):
            return frames.transpose(-1, -2).contiguous()
        raise NotImplementedError("frame supports axis 0 or -1")
    return dispatch.call("frame", f, [_t(x)])


def _overlap(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Sum [..., n, fl] frames, each ``hop`` after the last, into
    [..., (n - 1) * hop + fl]."""
    n, fl = frames.shape[-2], frames.shape[-1]
    seq = (n - 1) * hop + fl
    idx = (torch.arange(n, device=frames.device)[:, None] * hop
           + torch.arange(fl, device=frames.device)[None, :]).reshape(-1)
    out = torch.zeros(frames.shape[:-2] + (seq,), dtype=frames.dtype,
                      device=frames.device)
    return out.index_add(-1, idx, frames.reshape(frames.shape[:-2]
                                                 + (n * fl,)))


def overlap_add(x, hop_length: int, axis: int = -1, name=None):
    """The inverse of ``frame``: [..., frame_length, num_frames] -> [...,
    seq] (axis -1), [num_frames, frame_length, ...] -> [seq, ...] (axis
    0)."""
    def f(a):
        if axis == 0:
            return _overlap(a.movedim((0, 1), (-2, -1)),
                            hop_length).movedim(-1, 0)
        if axis in (-1, a.dim() - 1):
            return _overlap(a.transpose(-1, -2), hop_length)
        raise NotImplementedError("overlap_add supports axis 0 or -1")
    return dispatch.call("overlap_add", f, [_t(x)])


def _window(window, win_length, n_fft, like: Tensor) -> Tensor:
    dev = like._data.device
    if window is None:
        win = torch.ones(win_length, dtype=torch.float32, device=dev)
    else:
        win = window._data if isinstance(window, Tensor) \
            else torch.as_tensor(window, device=dev)
    if win_length < n_fft:          # centred in n_fft
        lpad = (n_fft - win_length) // 2
        win = TF.pad(win, (lpad, n_fft - win_length - lpad))
    return window if isinstance(window, Tensor) and win is window._data \
        else Tensor(win)


def stft(x, n_fft: int, hop_length=None, win_length=None, window=None,
         center: bool = True, pad_mode: str = "reflect",
         normalized: bool = False, onesided: bool = True, name=None):
    """Short-time Fourier transform: [B, seq] or [seq] real -> [B, bins,
    num_frames] complex (bins n_fft // 2 + 1 when ``onesided``)."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    xt = _t(x)

    def f(a, w):
        squeeze = a.dim() == 1
        if squeeze:
            a = a[None]
        if center:
            pad = n_fft // 2
            a = TF.pad(a[:, None], (pad, pad), mode=pad_mode)[:, 0]
        frames = a.unfold(-1, n_fft, hop_length) * w   # [B, n, n_fft]
        spec = (torch.fft.rfft(frames, dim=-1) if onesided
                else torch.fft.fft(frames, dim=-1))
        if normalized:
            spec = spec / (n_fft ** 0.5)
        spec = spec.transpose(-1, -2)
        return spec[0] if squeeze else spec
    return dispatch.call("stft", f, [xt, _window(window, win_length, n_fft,
                                                 xt)])


def istft(x, n_fft: int, hop_length=None, win_length=None, window=None,
          center: bool = True, normalized: bool = False,
          onesided: bool = True, length=None, return_complex: bool = False,
          name=None):
    """The inverse STFT: overlap-add of the inverse transforms, divided
    by the summed squared window."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    if return_complex and onesided:
        raise ValueError(
            "return_complex=True requires onesided=False (a complex output "
            "implies a two-sided spectrum)")
    xt = _t(x)

    def f(a, w):
        squeeze = a.dim() == 2
        if squeeze:
            a = a[None]
        spec = a.transpose(-1, -2)                    # [B, n, bins]
        if normalized:
            spec = spec * (n_fft ** 0.5)
        if onesided:
            frames = torch.fft.irfft(spec, n=n_fft, dim=-1)
        else:
            frames = torch.fft.ifft(spec, dim=-1)
            if not return_complex:
                frames = frames.real
        frames = frames * w
        n = frames.shape[1]
        out = _overlap(frames, hop_length)
        norm = _overlap((w * w).expand(n, n_fft), hop_length)
        out = out / torch.clamp_min(norm, 1e-10)
        seq = out.shape[-1]
        if center:
            pad = n_fft // 2
            out = out[..., pad:seq - pad]
        if length is not None:
            out = out[..., :length]
        return out[0] if squeeze else out
    return dispatch.call("istft", f, [xt, _window(window, win_length, n_fft,
                                                  xt)])


__all__ = ["frame", "overlap_add", "stft", "istft"]

register_module(sys.modules[__name__], "signal")
