"""paddle.fft, the discrete Fourier transforms (counterpart of
``paddle_tpu/fft.py``): each a ``torch.fft`` body (cuFFT on the card)
behind ``dispatch.call``, differentiable through torch autograd. The
N-d hermitian pairs follow the JAX package's identities
(hfftn(a) = irfftn(conj(a)), ihfftn(a) = conj(rfftn(a)), the norm
swapped), where ``torch.fft`` has its own forms.
"""
from __future__ import annotations

import torch

from .core import dispatch
from .core.dtype import convert_dtype
from .core.place import current_device
from .core.tensor import Tensor, as_tensor


def _t(x):
    return x if isinstance(x, Tensor) else as_tensor(x)


def _norm(norm):
    if norm not in ("forward", "backward", "ortho"):
        raise ValueError(f"norm must be forward/backward/ortho, got {norm}")
    return norm


def _mk1(opname, tfn):
    def op(x, n=None, axis=-1, norm="backward", name=None):
        nm = _norm(norm)
        return dispatch.call(opname, lambda a: tfn(a, n=n, dim=axis,
                                                   norm=nm), [_t(x)])
    op.__name__ = op.__qualname__ = opname
    op.__doc__ = f"1-D ``{opname}`` along ``axis``."
    return op


def _mk2(opname, tfn):
    def op(x, s=None, axes=(-2, -1), norm="backward", name=None):
        nm = _norm(norm)
        return dispatch.call(opname, lambda a: tfn(
            a, s=s, dim=tuple(axes), norm=nm), [_t(x)])
    op.__name__ = op.__qualname__ = opname
    op.__doc__ = f"2-D ``{opname}`` over ``axes``."
    return op


def _mkn(opname, tfn):
    def op(x, s=None, axes=None, norm="backward", name=None):
        nm = _norm(norm)
        return dispatch.call(opname, lambda a: tfn(
            a, s=s, dim=None if axes is None else tuple(axes), norm=nm),
            [_t(x)])
    op.__name__ = op.__qualname__ = opname
    op.__doc__ = f"N-d ``{opname}`` over ``axes`` (every dim when None)."
    return op


fft = _mk1("fft", torch.fft.fft)
ifft = _mk1("ifft", torch.fft.ifft)
rfft = _mk1("rfft", torch.fft.rfft)
irfft = _mk1("irfft", torch.fft.irfft)
hfft = _mk1("hfft", torch.fft.hfft)
ihfft = _mk1("ihfft", torch.fft.ihfft)

fft2 = _mk2("fft2", torch.fft.fft2)
ifft2 = _mk2("ifft2", torch.fft.ifft2)
rfft2 = _mk2("rfft2", torch.fft.rfft2)
irfft2 = _mk2("irfft2", torch.fft.irfft2)

fftn = _mkn("fftn", torch.fft.fftn)
ifftn = _mkn("ifftn", torch.fft.ifftn)
rfftn = _mkn("rfftn", torch.fft.rfftn)
irfftn = _mkn("irfftn", torch.fft.irfftn)


def fftfreq(n, d=1.0, dtype="float32", name=None):
    return Tensor(torch.fft.fftfreq(n, d, dtype=convert_dtype(dtype),
                                    device=current_device()))


def rfftfreq(n, d=1.0, dtype="float32", name=None):
    return Tensor(torch.fft.rfftfreq(n, d, dtype=convert_dtype(dtype),
                                     device=current_device()))


def fftshift(x, axes=None, name=None):
    return dispatch.call("fftshift", lambda a: torch.fft.fftshift(
        a, dim=axes), [_t(x)])


def ifftshift(x, axes=None, name=None):
    return dispatch.call("ifftshift", lambda a: torch.fft.ifftshift(
        a, dim=axes), [_t(x)])


_INV_NORM = {"backward": "forward", "forward": "backward", "ortho": "ortho"}


def _axes(a, axes, two_d):
    if axes is not None:
        return tuple(axes)
    return (-2, -1) if two_d else tuple(range(a.dim()))


def _mk_hfftn(opname, axes_default, two_d):
    def op(x, s=None, axes=axes_default, norm="backward", name=None):
        inv = _INV_NORM[_norm(norm)]
        return dispatch.call(opname, lambda a: torch.fft.irfftn(
            torch.conj(a), s=s, dim=_axes(a, axes, two_d), norm=inv),
            [_t(x)])
    op.__name__ = op.__qualname__ = opname
    op.__doc__ = f"``{opname}``: the inverse real transform of conj(x)."
    return op


def _mk_ihfftn(opname, axes_default, two_d):
    def op(x, s=None, axes=axes_default, norm="backward", name=None):
        inv = _INV_NORM[_norm(norm)]
        return dispatch.call(opname, lambda a: torch.conj_physical(
            torch.fft.rfftn(a, s=s, dim=_axes(a, axes, two_d), norm=inv)),
            [_t(x)])
    op.__name__ = op.__qualname__ = opname
    op.__doc__ = f"``{opname}``: conj of the real transform of x."
    return op


hfft2 = _mk_hfftn("hfft2", (-2, -1), True)
ihfft2 = _mk_ihfftn("ihfft2", (-2, -1), True)
hfftn = _mk_hfftn("hfftn", None, False)
ihfftn = _mk_ihfftn("ihfftn", None, False)


__all__ = ["fft", "ifft", "rfft", "irfft", "hfft", "ihfft", "fft2",
           "ifft2", "rfft2", "irfft2", "fftn", "ifftn", "rfftn", "irfftn",
           "hfft2", "ihfft2", "hfftn", "ihfftn",
           "fftfreq", "rfftfreq", "fftshift", "ifftshift"]
